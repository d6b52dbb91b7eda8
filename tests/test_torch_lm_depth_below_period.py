"""gemma3 cut below one sliding-window period (2 layers, both local): the
reference's parameter tree has a ``periods`` group of length 0 beside a
2-layer ``tail``, and the port builds no module for the empty group. The
port takes that tree and gives it back (``from_reference``,
``to_reference``), seeds such a model (``init_params``), and its forward,
train loss and bfloat16 training steps on the tensor-parallel and FSDP
meshes equal the reference's and each other. Until this was repaired,
``init_params`` refused the empty leaves, which the card showed when
``chip_smoke.py --coverage lm`` cut gemma3's training to 2 layers."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api, lm
from repro_torch.train import loop
from test_torch_lm_common import as_jax, as_torch, assert_close, batch
from test_torch_tp_common import one_torch_thread  # noqa: F401
from test_torch_train_common import reduced

ARCH, LAYERS = "gemma3-27b", 2


@pytest.fixture(scope="module")
def cut():
    ref_cfg, cfg = reduced(ARCH, n_layers=LAYERS)
    params = jax.tree.map(np.asarray, ref_api.init_params(ref_cfg, jax.random.PRNGKey(0)))
    return ref_cfg, cfg, params


def test_the_reference_tree_has_an_empty_group(cut):
    ref_cfg, cfg, params = cut
    assert lm.layer_groups(cfg) == [("periods", 0, "attn_period"), ("tail", 2, "attn_local")]
    assert params["groups"]["periods"]["ln1"]["scale"].shape[0] == 0


def test_round_trip_keeps_the_empty_group(cut):
    _, cfg, params = cut
    back = api.to_reference(api.from_reference(cfg, params, device="cpu"))
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [str(p) for p, _ in got] == [str(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path


def test_forward_and_loss_match_the_reference(cut):
    ref_cfg, cfg, params = cut
    model = api.from_reference(cfg, params, device="cpu")
    bt = batch(cfg, 2, 24)  # past the reduced config's 16-token window
    h = lm.forward_hidden(cfg, model, as_torch(bt)["tokens"])
    rh = ref_lm.forward_hidden(ref_cfg, params, as_jax(bt)["tokens"])
    assert_close(lm.lm_logits(cfg, model, h), ref_lm.lm_logits(ref_cfg, params, rh),
                 what="logits")
    loss = api.train_loss_fn(cfg)(model, as_torch(bt))
    want = ref_api.train_loss_fn(ref_cfg)(params, as_jax(bt))
    assert abs(float(loss) - float(want)) <= 1e-5


def test_seeded_training_on_the_meshes(cut):
    """Seeded weights (``init_params``), 2 steps through ``train.loop.train``
    unsharded, tensor-parallel and with FSDP rules on (data 2, model 4):
    the sharded runs' losses equal the unsharded run's."""
    _, cfg, _ = cut
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    mesh = SimMesh((2, 4), ("data", "model"))
    kw = dict(n_steps=2, log_every=100, lr_kw={"peak": 1e-2, "warmup": 1, "total": 3})
    runs = [loop.train(cfg, 2, 24, loop.LoopConfig(**kw), device="cpu", mesh=m, rules=r)
            ["losses"] for m, r in ((None, None), (mesh, rules_for_mesh(mesh)),
                                   (mesh, rules_for_mesh(mesh, fsdp=True)))]
    assert np.isfinite(runs[0]).all()
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-2)
    assert runs[2] == runs[1]
