"""PyTorch port, the decode variants: ``decode_inplace`` for every
architecture against the baseline decode and the reference's, and gemma3's
in-place and ring caches against the full forward and the reference's
caches (the counterparts of
``test_models.py::test_gemma3_perf_variants_match_forward`` and
``test_decode_inplace_matches_all_archs``).

Float32 on the CPU, atol = rtol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro_torch.models import api, lm
from repro_torch.serve import engine
from test_torch_lm_common import (ARCHS, as_jax, as_torch, assert_close, assert_tree_close,
                             batch, clone_tree, port_model, reduced, ref_params, to_numpy)


def prompt(cfg, l=24, seed=0):
    bt = batch(cfg, 2, l, seed)
    return {k: v for k, v in bt.items() if k != "labels"}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_inplace_matches_baseline(arch):
    """``decode_inplace`` changes no result: the same logits and cache as the
    baseline decode, and the reference's."""
    ref_cfg, base = reduced(arch)
    cfg = dataclasses.replace(base, decode_inplace=True)
    model, params = port_model(arch, base), ref_params(arch)
    inputs = prompt(cfg, 16, seed=1)
    logits0, cache, pos = api.prefill_fn(base)(model, as_torch(inputs))
    cache = engine.pad_cache(cache, pos + 4)
    tok = torch.argmax(logits0, -1)[:, None].to(torch.int32)
    l_base, c_base = api.decode_fn(base)(model, clone_tree(cache), tok, pos)
    l_inp, c_inp = api.decode_fn(cfg)(model, clone_tree(cache), tok, pos)
    assert torch.equal(l_base, l_inp)
    assert_tree_close(c_inp, c_base, atol=0, rtol=0)

    rlogits0, rcache, rpos = jax.jit(ref_api.prefill_fn(ref_cfg))(params, as_jax(inputs))
    rcache = ref_engine.pad_cache(rcache, int(rpos) + 4)
    rcfg = dataclasses.replace(ref_cfg, decode_inplace=True)
    rl, _ = jax.jit(ref_api.decode_fn(rcfg))(params, rcache, jnp.asarray(tok.numpy()), rpos)
    assert_close(l_inp, rl, what="decode_inplace logits")


@pytest.mark.parametrize("flags", [
    {"decode_inplace": True},
    {"ring_local_cache": True},
    {"ring_local_cache": True, "decode_inplace": True},
])
def test_gemma3_variants_match_forward_and_reference(flags):
    """gemma3's in-place and ring caches: teacher-forced decode reproduces the
    full forward; the ring cache's layout and values equal the reference's."""
    ref_base, base = reduced("gemma3-27b")
    cfg = dataclasses.replace(base, **flags)
    ref_cfg = dataclasses.replace(ref_base, **flags)
    model, params = port_model("gemma3-27b", base), ref_params("gemma3-27b")
    toks = prompt(cfg, 24)["tokens"]
    want = lm.lm_logits(cfg, model, lm.forward_hidden(cfg, model, torch.from_numpy(toks)))
    cut = toks.shape[1] - 5
    logits, cache, pos = api.prefill_fn(cfg)(model, {"tokens": torch.from_numpy(toks[:, :cut])})
    cache = engine.prepare_decode_cache(cfg, cache, cut, toks.shape[1])
    rlogits, rcache, rpos = jax.jit(ref_api.prefill_fn(ref_cfg))(
        params, {"tokens": jnp.asarray(toks[:, :cut])})
    rcache = ref_engine.prepare_decode_cache(ref_cfg, rcache, cut, toks.shape[1])
    assert_tree_close(cache, to_numpy(rcache))
    if cfg.ring_local_cache:
        assert cache["periods"]["local"]["k"].shape[3] == cfg.local_window
    dec = jax.jit(ref_api.decode_fn(ref_cfg))
    got = [logits]
    for i in range(4):
        tok = toks[:, cut + i:cut + i + 1]
        logits, cache = api.decode_fn(cfg)(model, cache, torch.from_numpy(tok), pos + i)
        rlogits, rcache = dec(params, rcache, jnp.asarray(tok), rpos + i)
        assert_close(logits, rlogits, what=f"step {i}")
        got.append(logits)
    assert_tree_close(cache, to_numpy(rcache))
    assert_close(torch.stack(got, dim=1), want[:, cut - 1:cut + 4])
