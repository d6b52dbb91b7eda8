"""Gradients of the port's models, first half of the families: ``jax.grad``
of the reference's ``train_loss`` against autograd through the port
(``train.step._grads_of``), each arch at its reduced config with the same
weights and batch, float32 on the CPU, rtol 1e-4 and atol 1e-6 per leaf;
and the port's activation checkpointing (``cfg.remat``) on against off,
bit for bit. ``test_torch_train_grads_more.py`` has the other half.
"""

import dataclasses

import jax
import pytest
import torch

from repro.models import api as ref_api
from repro_torch.models import api, lm
from repro_torch.train import step as step_mod
from test_torch_lm_common import batch, port_model, reduced, ref_params
from test_torch_train_common import as_jax, as_torch, assert_trees_close, assert_trees_equal

ARCHS = ["olmo-1b", "qwen3-1.7b", "gemma3-27b", "mamba2-130m", "internvl2-26b"]
RTOL, ATOL = 1e-4, 1e-6


def check_grads(arch):
    ref_cfg, cfg = reduced(arch)
    params = ref_params(arch)
    bt = batch(cfg, 2, 32)
    loss, want = jax.jit(jax.value_and_grad(ref_api.train_loss_fn(ref_cfg)))(params,
                                                                           as_jax(bt))
    got_loss, got = step_mod._grads_of(api.train_loss_fn(cfg), port_model(arch), as_torch(bt), 1)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert_trees_close(got, want, RTOL, ATOL, arch)


def check_remat(arch, monkeypatch):
    """remat on == off bit for bit, and on runs every layer (or period)
    under ``torch.utils.checkpoint``."""
    _, cfg = reduced(arch)
    assert not cfg.remat  # the reduced configs turn it off
    model, bt = port_model(arch), as_torch(batch(cfg, 2, 32))
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    off_loss, off = step_mod._grads_of(api.train_loss_fn(cfg), model, bt, 1)
    assert not calls
    on_cfg = dataclasses.replace(cfg, remat=True)
    on_loss, on = step_mod._grads_of(api.train_loss_fn(on_cfg), model, bt, 1)
    units = sum(n for _, n, _ in lm.layer_groups(cfg)) if cfg.family != "audio" else (
        cfg.encoder_layers + cfg.n_layers)
    assert len(calls) == units
    assert torch.equal(on_loss, off_loss)
    assert_trees_equal(on, off, f"{arch} remat")
    # serving records nothing: the parameters are back to requires_grad=False
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch, monkeypatch):
    check_remat(arch, monkeypatch)
