"""Training sharded over the model axis: the port's GSPMD step
(``build_train_step(mesh=, rules=)``) on ``SimMesh((2, 4), ("data",
"model"))`` against the JAX package's on ``mesh_dm``, steps 1-3 at
``lr > 0`` for the six reduced dense and MoE configs
(``test_torch_tp_common.check_steps``: loss, ``grad_norm``, the gathered
parameters, step 1's gradient against the unsharded port, the byte
model), and ``train_loss`` against the reference's loss of the weights. The clip's norm and the optimizers over shards (Adafactor's
statistics factored over split dimensions) equal the unsharded ones; a
sharded checkpoint is the unsharded run's file and restores (also
through ``restore(mesh=, pspecs=)``) into the sharded step; the loop
trains a sharded model as it trains the unsharded one."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import sorted_leaves
from repro_torch.models import api, lm
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, train
from test_torch_tp_common import (ARCHS, BATCH, MESH, ROWS, RULES, SEQ, SIZE, check_steps,
                                  configs_of, one_torch_thread,  # noqa: F401
                                  port_sharded, step_reference)
from test_torch_train_common import LR_KW, as_torch, assert_trees_close


@pytest.fixture(scope="module")
def reference(mesh_dm):
    return step_reference(mesh_dm, "gspmd")


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_matches_reference(reference, arch):
    check_steps(reference, arch, "gspmd")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(reference, arch):
    """``api.train_loss_fn(cfg, rules, mesh)`` of the sharded model against
    the reference's loss of the same weights and batch (its GSPMD step's
    first loss, taken before the update), within 1e-5; the forward's
    model-axis calls are the byte model's first."""
    cfg, params, batch, want, _ = reference(arch)
    model = port_sharded(cfg, params)
    with torch.no_grad():
        loss = api.train_loss_fn(cfg, RULES, MESH)(model, as_torch(batch))
    assert abs(float(loss) - want[0]["loss"]) <= 1e-5, (float(loss), want[0]["loss"])
    calls = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE)
    assert list(model.tp.calls) == calls[:len(model.tp.calls)]


def _grad_tree(model, seed):
    """Seeded gradients shaped as the unsharded model's leaves."""
    rng = np.random.default_rng(seed)
    out = {}
    for p, lead, prms in api.param_leaves(model):
        shd.tree_set(out, p, torch.from_numpy(
            rng.normal(size=lead + tuple(prms[0].shape)).astype(np.float32)))
    return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b"])
def test_clip_and_optimizer_over_shards_equal_unsharded(arch):
    """The same gradients through the unsharded and the sharded clip and
    optimizer (AdamW; Adafactor with its statistics factored over split
    dimensions), two updates: parameters and state equal to float32
    rounding; the optimizer's collectives equal its byte model."""
    _, cfg = configs_of(arch)
    plain = api.init_params(cfg, 0, device="cpu")
    sharded = api.shard(plain, RULES, MESH)
    opt = optim.get(cfg.optimizer)
    s0, s1 = opt.init(plain), opt.init(sharded)
    for seed in (1, 2):
        g = _grad_tree(plain, seed)
        held = api.held_leaves(sharded, g)
        assert_trees_close(api.global_leaves(sharded, held), g, 0, 0)
        g0, n0 = optim.clip_by_global_norm(g, 1.0)
        sharded.tp.reset()
        g1, n1 = optim.clip_by_global_norm(held, 1.0, sharded)
        assert float(n1) == pytest.approx(float(n0), rel=1e-6)
        plain, s0 = opt.apply(plain, g0, s0, 1e-2)
        sharded, s1 = opt.apply(sharded, g1, s1, 1e-2)
        assert list(sharded.tp.calls) == optim.tp_calls(sharded)
    assert_trees_close(api.to_reference(sharded), api.to_reference(plain), 1e-5, 1e-6)
    assert_trees_close(optim.global_state(sharded, s1), s0, 1e-5, 1e-9)


def test_sharded_checkpoint_round_trip(tmp_path):
    """The loop trains a sharded model as the unsharded one; its checkpoint
    is the unsharded run's file (the same keys, shapes and dtypes, values to
    the steps' float32 rounding); it restores into a sharded model and
    state, directly or through ``restore(mesh=, pspecs=)``, equal to what
    the run held, and the restored step continues as the run does."""
    _, cfg = configs_of("kimi-k2-1t-a32b")
    lc = dict(n_steps=2, ckpt_every=2, async_ckpt=False, lr_kw=LR_KW)
    plain = train(cfg, BATCH, SEQ, LoopConfig(ckpt_dir=str(tmp_path / "a"), **lc), device="cpu")
    run = train(cfg, BATCH, SEQ, LoopConfig(ckpt_dir=str(tmp_path / "b"), **lc), device="cpu",
                mesh=MESH)
    assert run["losses"] == pytest.approx(plain["losses"], abs=1e-5)
    a, b = np.load(tmp_path / "a" / "arrays.npz"), np.load(tmp_path / "b" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6, err_msg=k)
    opt = optim.get(cfg.optimizer)
    sd = opt.state_defs(api.param_defs(cfg))
    specs = shd.tree_pspecs(sd, RULES, MESH)
    tp = api.tensor_parallel(RULES, MESH, "cpu")
    step, trees = ckpt.restore(str(tmp_path / "b"), {"params": api.build_model(cfg, "cpu", tp),
                                                     "opt_state": sd}, device="cpu")
    _, placed = ckpt.restore(str(tmp_path / "b"), {"params": api.build_model(cfg, "cpu", tp),
                                                   "opt_state": sd},
                             mesh=MESH, pspecs={"opt_state": specs}, device="cpu")
    model = trees["params"]
    state = optim.local_state(model, trees["opt_state"])
    via_mesh = optim.from_placed(model, placed["opt_state"], MESH, specs)
    assert step == 2
    for (p, x), (_, y), (_, z) in zip(sorted_leaves(state), sorted_leaves(via_mesh),
                                      sorted_leaves(run["opt_state"])):
        assert torch.equal(x, y) and torch.equal(x, z), p
    assert_trees_close(api.to_reference(model), api.to_reference(run["params"]), 0, 0)
    fn = step_mod.build_train_step(cfg, mesh=MESH, rules=RULES, lr_kw=LR_KW)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, BATCH, SEQ).batch_at(2).items()}
    _, _, m0 = fn(model, state, batch, 2)
    _, _, m1 = fn(run["params"], run["opt_state"], batch, 2)
    assert float(m0["loss"]) == float(m1["loss"])
    # the embedding's backward accumulates in a thread-dependent order on the CPU
    assert_trees_close(api.to_reference(model), api.to_reference(run["params"]), 1e-6, 1e-9)
