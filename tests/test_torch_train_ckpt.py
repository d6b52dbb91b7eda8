"""The port's data stream and checkpoints against the JAX package's:
``SyntheticLM.batch_at`` bit for bit for the dense, VLM and audio
families; the reference's checkpoint tests on the port (round trip bit
exact, async save, atomic overwrite, restart continuing identically); a
reference-written checkpoint restored into the port and stepped once as
the reference steps it; a port-written checkpoint restored through the
reference's ``ckpt.restore`` bit for bit, for AdamW and Adafactor; a
bfloat16 leaf written and read as the ``|V2`` bits the reference writes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import api as ref_api
from repro.train import optim as ref_optim, step as ref_step
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, SimulatedFailure, train
from test_torch_lm_common import to_numpy
from test_torch_train_common import (LR_KW, as_jax, as_torch, assert_adam_close,
                                     assert_trees_equal, lm_batch, numpy_tree, port_model,
                                     reduced, ref_init, tiny)


@pytest.mark.parametrize("arch", ["olmo-1b", "internvl2-26b", "whisper-medium"])
def test_batch_at_matches_reference(arch):
    ref_cfg, cfg = reduced(arch)
    for batch, seq in ((8, 64), (4, 61)):
        ref, port = RefSyntheticLM(ref_cfg, batch, seq), SyntheticLM(cfg, batch, seq)
        for step, shard, n_shards in ((0, 0, 1), (3, 1, 4), (17, 3, 4), (1000, 1, 2)):
            want = ref.batch_at(step, shard, n_shards)
            got = port.batch_at(step, shard, n_shards)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def qwen_tiny():
    """tests/test_checkpoint.py's ``_tiny()``."""
    return tiny("qwen3-1.7b")


def test_roundtrip_bit_exact(tmp_path):
    _, cfg = qwen_tiny()
    model = api.init_params(cfg, 0, device="cpu")
    state = optim.ADAMW.init(model)
    state["m"]["embed"]["tok"].normal_()
    path = str(tmp_path / "ck")
    ckpt.save(path, 17, {"params": model, "opt_state": state})
    assert ckpt.latest_step(path) == 17
    step, trees = ckpt.restore(path, {"params": api.build_model(cfg, "cpu"),
                                      "opt_state": optim.ADAMW.state_defs(api.param_defs(cfg))},
                               device="cpu")
    assert step == 17
    assert_trees_equal(api.to_reference(trees["params"]), api.to_reference(model))
    assert_trees_equal(trees["opt_state"], state)


def test_async_save(tmp_path):
    _, cfg = qwen_tiny()
    model = api.init_params(cfg, 0, device="cpu")
    path = str(tmp_path / "ck")
    t = ckpt.save(path, 5, {"params": model}, async_=True)
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest_step(path) == 5


def test_atomic_overwrite(tmp_path):
    _, cfg = qwen_tiny()
    model = api.init_params(cfg, 0, device="cpu")
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, {"params": model})
    two = api.init_params(cfg, 1, device="cpu")
    ckpt.save(path, 2, {"params": two})
    assert not os.path.exists(path + ".tmp")
    step, trees = ckpt.restore(path, {"params": api.build_model(cfg, "cpu")}, device="cpu")
    assert step == 2
    assert_trees_equal(api.to_reference(trees["params"]), api.to_reference(two))


def test_restart_continues_identically(tmp_path):
    """Kill at step 32, restart from the step-30 checkpoint: the final
    parameters equal an uninterrupted run's bit for bit."""
    _, cfg = qwen_tiny()
    loop_kw = dict(ckpt_every=10, log_every=1000,
                   lr_kw={"peak": 1e-3, "warmup": 2, "total": 40})
    ref = train(cfg, 4, 32, loop=LoopConfig(n_steps=40, **loop_kw), device="cpu")
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedFailure):
        train(cfg, 4, 32, loop=LoopConfig(n_steps=40, ckpt_dir=ck, fail_at_step=32,
                                          async_ckpt=False, **loop_kw), device="cpu")
    assert ckpt.latest_step(ck) == 30
    out = train(cfg, 4, 32, loop=LoopConfig(n_steps=40, ckpt_dir=ck, async_ckpt=False,
                                            **loop_kw), device="cpu")
    assert out["final_step"] == 40 and len(out["losses"]) == 10
    assert out["losses"] == ref["losses"][30:]
    assert_trees_equal(api.to_reference(out["params"]), api.to_reference(ref["params"]))
    assert_trees_equal(out["opt_state"], ref["opt_state"])


def reference_state(ref_cfg, batch, n_steps):
    """The reference's parameters and AdamW state after ``n_steps`` steps."""
    params = ref_init(ref_cfg)
    fn = jax.jit(ref_step.build_train_step(ref_cfg, lr_kw=LR_KW))
    st = ref_optim.ADAMW.init(params)
    for s in range(n_steps):
        params, st, _ = fn(params, st, as_jax(batch), jnp.int32(s + 1))
    return params, st, fn


def test_reference_checkpoint_steps_alike_in_the_port(tmp_path):
    ref_cfg, cfg = qwen_tiny()
    batch = lm_batch(cfg.vocab, 4, 32)
    params, st, fn = reference_state(ref_cfg, batch, 2)
    path = str(tmp_path / "ck")
    ref_ckpt.save(path, 2, {"params": params, "opt_state": st})
    step, trees = ckpt.restore(path, {"params": api.build_model(cfg, "cpu"),
                                      "opt_state": optim.ADAMW.state_defs(api.param_defs(cfg))},
                               device="cpu")
    assert step == 2
    model, state = trees["params"], trees["opt_state"]
    assert_trees_equal(api.to_reference(model), to_numpy(params))
    assert_trees_equal(state, to_numpy(st))
    grads = jax.jit(lambda p: ref_step._grads_of(ref_api.train_loss_fn(ref_cfg), p,
                                                 as_jax(batch), 1)[1])(params)
    p2, st2, m = fn(params, st, as_jax(batch), jnp.int32(3))
    model, state, got = step_mod.build_train_step(cfg, lr_kw=LR_KW)(model, state,
                                                                     as_torch(batch), 3)
    assert abs(float(got["loss"]) - float(m["loss"])) <= 1e-5
    assert_adam_close(api.to_reference(model), p2, [grads], got["lr"], 1e-5, 1e-6)
    assert int(state["count"]) == 3


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_port_checkpoint_restores_through_the_reference(tmp_path, optimizer):
    ref_cfg, cfg = tiny("qwen3-1.7b", optimizer=optimizer)
    params = ref_init(ref_cfg)
    model = port_model(cfg, params)
    opt = optim.get(optimizer)
    state = opt.init(model)
    model, state, _ = step_mod.build_train_step(cfg, lr_kw=LR_KW)(
        model, state, as_torch(lm_batch(cfg.vocab, 4, 32)), 1)
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, {"params": model, "opt_state": state}, meta={"arch": cfg.name})
    templates = {"params": params, "opt_state": ref_optim.get(optimizer).init(params)}
    step, trees = ref_ckpt.restore(path, templates)
    assert step == 1
    assert_trees_equal(jax.tree.map(np.asarray, trees["params"]), api.to_reference(model))
    assert_trees_equal(jax.tree.map(np.asarray, trees["opt_state"]), state)
    keys = set(np.load(os.path.join(path, "arrays.npz")).files)
    want = {"opt_state/count", "params/embed/tok", "params/groups/blocks/attn/wq"}
    want |= ({"opt_state/m/embed/tok", "opt_state/v/groups/blocks/ln1/scale"}
             if optimizer == "adamw" else
             {"opt_state/f/embed/tok/vr", "opt_state/f/groups/blocks/ln1/scale/vc"})
    assert want <= keys


def test_bfloat16_leaf_is_v2_bits(tmp_path):
    """A bfloat16 model writes ``|V2`` arrays holding the same bytes the
    reference writes for the same weights, and reads them back bit for bit."""
    ref_cfg, cfg = tiny("qwen3-1.7b", param_dtype="bfloat16", compute_dtype="bfloat16")
    params = ref_init(ref_cfg)
    model = port_model(cfg, params)
    assert model.embed.tok.dtype == torch.bfloat16
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(mine, 1, {"params": model})
    ref_ckpt.save(theirs, 1, {"params": params})
    a = np.load(os.path.join(mine, "arrays.npz"))
    b = np.load(os.path.join(theirs, "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype.str == b[k].dtype.str == "|V2", k
        assert a[k].tobytes() == b[k].tobytes(), k
    _, trees = ckpt.restore(theirs, {"params": api.build_model(cfg, "cpu")}, device="cpu")
    assert trees["params"].embed.tok.dtype == torch.bfloat16
    assert_trees_equal(api.to_reference(trees["params"]), api.to_reference(model))
    # the reference's own restore hands the leaves back as |V2 void arrays
    _, back = ref_ckpt.restore(mine, {"params": params})
    assert np.asarray(back["params"]["embed"]["tok"]).dtype.str == "|V2"
