"""FSDP (ZeRO-3) beside tensor parallelism for the other families, held
against the port's own runs of the same weights (each already held to the
reference by the ``test_torch_tp_*`` files, so no reference compile
here): reduced kimi-k2 (MoE, Adafactor), jamba (hybrid periods), internvl2
(the VLM's patch projection) and whisper (the encoder, a tied table)
with FSDP rules on (data 2, model 4) against the tensor-parallel model:
prefill logits and cache, decode and the loss bit for bit (a gather is a
concatenation), three GSPMD steps within 1e-6 of each leaf's largest;
on data 8 against the unsharded model, the forward bit for bit; every
record equal to the byte model. Also: a mesh whose data size does not
divide ``d_model`` keeps every leaf whole over the data axes (the
reference's divisibility fallback); an FSDP checkpoint is the unsharded
run's file, restores into the FSDP step, and a restart at step 2 is the
uninterrupted run bit for bit; ``launch.train --smoke`` with FSDP rules
trains FSDP on simulated ranks; FSDP over both batch axes (pod x data,
with and without a model axis) holds the spec's blocks and serves and
differentiates as the model without it."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh, sorted_leaves
from repro_torch.models import api, lm
from repro_torch.serve import engine
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, SimulatedFailure, train
from test_torch_fsdp_common import BATCH, NEW, PROMPT, SEQ, assert_records
from test_torch_tp_common import inputs, one_torch_thread  # noqa: F401
from test_torch_train_common import LR_KW, STEPS

ARCHS = ("kimi-k2-1t-a32b", "jamba-v0.1-52b", "internvl2-26b", "whisper-medium")
DM = SimMesh((2, 4), ("data", "model"))
D8 = SimMesh(8)
LEAF_TOL = 1e-6  # of each leaf's largest magnitude


def cfg_of(arch, **changes):
    return dataclasses.replace(configs.reduced(configs.get_config(arch)), **changes)


def batch_of(cfg):
    return {k: torch.from_numpy(v) for k, v in inputs(cfg, BATCH, SEQ).items()}


def prompt_of(batch):
    return {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in batch.items()
            if k != "labels"}


def serve(cfg, model, rules, mesh, batch):
    """(prefill logits, the cache in the reference's layout, two decode
    steps' logits)."""
    with torch.no_grad():
        logits, cache, pos = api.prefill_fn(cfg, rules, mesh)(model, prompt_of(batch))
        whole = api.global_cache(model, cache)
        cache = engine.prepare_decode_cache(cfg, cache, pos, pos + NEW)
        steps = []
        for i in range(2):
            tok = batch["tokens"][:, PROMPT + i:PROMPT + i + 1]
            dl, cache = api.decode_fn(cfg, rules, mesh)(model, cache, tok, pos + i)
            steps.append(dl)
    return logits, whole, steps


def assert_equal_trees(a, b):
    for (pa, x), (pb, y) in zip(sorted_leaves(a), sorted_leaves(b)):
        assert pa == pb and torch.equal(x, y), pa


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_tensor_parallel_bit_for_bit(arch):
    """Serving and the loss with FSDP rules on (data 2, model 4) are the
    tensor-parallel model's bit for bit; on data 8 the unsharded model's;
    each pass's FSDP record is the byte model's."""
    cfg = cfg_of(arch)
    batch = batch_of(cfg)
    for mesh, base_rules in ((DM, rules_for_mesh(DM)), (D8, None)):
        rules = rules_for_mesh(mesh, fsdp=True)
        base = api.init_params(cfg, 0, device="cpu", rules=base_rules,
                               mesh=mesh if base_rules else None)
        model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
        want = serve(cfg, base, base_rules, mesh if base_rules else None, batch)
        model.fsdp.reset()
        got = serve(cfg, model, rules, mesh, batch)
        assert torch.equal(got[0], want[0])
        assert_equal_trees(got[1], want[1])
        for a, b in zip(got[2], want[2]):
            assert torch.equal(a, b)
        calls = (lm.fsdp_calls(cfg, "prefill", mesh, rules)
                 + 2 * lm.fsdp_calls(cfg, "decode", mesh, rules))
        assert_records(model, calls, "mesh_dm" if mesh == DM else "mesh8")
        with torch.no_grad():
            a = api.train_loss_fn(cfg, base_rules, mesh if base_rules else None)(base, batch)
            b = api.train_loss_fn(cfg, rules, mesh)(model, batch)
        assert torch.equal(a, b)


def _leaf_close(got, want, what):
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= LEAF_TOL * scale, (what, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_equal_tensor_parallel(arch):
    """Three GSPMD steps with FSDP rules on (data 2, model 4), remat on,
    each taken from the tensor-parallel run's parameters and state before
    it, against that run's step: the gradient bit for bit, the loss and
    the norm within 1e-6, every parameter and optimizer-state leaf within
    1e-6 of its largest (the clip's norm sums the shards in another
    order); each step's FSDP record (remat's recompute included) the byte
    model's, the model-axis record ``lm.tp_calls``'."""
    cfg = cfg_of(arch, remat=True)
    batch = batch_of(cfg)
    rules = rules_for_mesh(DM, fsdp=True)
    tp_rules = rules_for_mesh(DM)
    base = api.init_params(cfg, 0, device="cpu", rules=tp_rules, mesh=DM)
    sa = optim.get(cfg.optimizer).init(base)
    fa = step_mod.build_train_step(cfg, mesh=DM, rules=tp_rules, lr_kw=LR_KW)
    fb = step_mod.build_train_step(cfg, mesh=DM, rules=rules, lr_kw=LR_KW)
    for s in STEPS:
        model = api.from_reference(cfg, api.to_reference(base), device="cpu", rules=rules,
                                   mesh=DM)
        sb = shd.tree_map(torch.clone, optim.local_state(model, optim.global_state(base, sa)))
        ga = step_mod._grads_of(api.train_loss_fn(cfg, tp_rules, DM), base, batch, 1)[1]
        gb = step_mod._grads_of(api.train_loss_fn(cfg, rules, DM), model, batch, 1)[1]
        assert_equal_trees(api.global_leaves(model, gb), api.global_leaves(base, ga))
        del ga, gb
        model.tp.reset()
        model.fsdp.reset()
        base, sa, ma = fa(base, sa, batch, s)
        model, sb, mb = fb(model, sb, batch, s)
        assert float(mb["loss"]) == float(ma["loss"])
        assert float(mb["grad_norm"]) == pytest.approx(float(ma["grad_norm"]), rel=1e-6)
        # the model axis's calls as the byte model has them: Adafactor's
        # statistics of a leaf FSDP also splits are a data rank's share
        assert sorted(model.tp.calls) == sorted(
            lm.tp_calls(cfg, "train", BATCH // 2, SEQ, 4) + optim.tp_calls(model))
        assert_records(model, lm.fsdp_calls(cfg, "train", DM, rules) + optim.fsdp_calls(model),
                       "mesh_dm", ordered=False)
        want = {p: torch.from_numpy(np.asarray(v)) for p, v in
                sorted_leaves(api.to_reference(base))}
        for p, v in sorted_leaves(api.to_reference(model)):
            _leaf_close(torch.from_numpy(np.asarray(v)), want[p], (s, p))
        want = dict(sorted_leaves(optim.global_state(base, sa)))
        for p, v in sorted_leaves(optim.global_state(model, sb)):
            if v.dtype.is_floating_point:
                _leaf_close(v, want[p], (s, p))
            else:
                assert torch.equal(v, want[p]), p


def test_indivisible_data_axis_keeps_leaves_whole():
    """On (data 3, model 2) no ``embed`` dimension (128) splits three ways:
    every leaf is held as tensor parallelism alone holds it, no FSDP call
    is made, and the model serves and steps as the tensor-parallel one."""
    cfg = cfg_of("deepseek-7b")
    mesh = SimMesh((3, 2), ("data", "model"))
    rules = rules_for_mesh(mesh, fsdp=True)
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    base = api.init_params(cfg, 0, device="cpu", rules=rules_for_mesh(mesh), mesh=mesh)
    for (pa, a), (pb, b) in zip(model.named_parameters(), base.named_parameters()):
        assert pa == pb and a.fsdp_dim is None and torch.equal(a, b), pa
    rows = {k: v[:6] for k, v in batch_of(cfg).items()}
    with torch.no_grad():
        assert torch.equal(api.prefill_fn(cfg, rules, mesh)(model, prompt_of(rows))[0],
                           api.prefill_fn(cfg, rules_for_mesh(mesh), mesh)(
                               base, prompt_of(rows))[0])
    state = optim.get(cfg.optimizer).init(model)
    step_mod.build_train_step(cfg, mesh=mesh, rules=rules, lr_kw=LR_KW)(model, state, rows, 1)
    assert model.fsdp.calls == [] and lm.fsdp_calls(cfg, "train", mesh, rules) == []
    assert optim.fsdp_calls(model) == []


@pytest.mark.parametrize("mesh", [DM, D8], ids=["data2_model4", "data8"])
def test_checkpoint_round_trip_and_restart(tmp_path, mesh):
    """The loop trains FSDP 4 steps with a checkpoint every 2: the file is
    the unsharded model's and state's (the reference's keys and shapes),
    it restores into the FSDP model bit for bit, and a run that fails at
    step 2 and restarts from it ends bit-equal to the uninterrupted run."""
    cfg = cfg_of("qwen3-moe-235b-a22b")
    rules = rules_for_mesh(mesh, fsdp=True)
    lc = dict(n_steps=4, ckpt_every=2, async_ckpt=False, lr_kw=LR_KW)
    whole = train(cfg, BATCH, SEQ, LoopConfig(ckpt_dir=str(tmp_path / "a"), **lc),
                  device="cpu", mesh=mesh, rules=rules)
    assert whole["params"].fsdp is not None
    with pytest.raises(SimulatedFailure):
        train(cfg, BATCH, SEQ, LoopConfig(ckpt_dir=str(tmp_path / "b"), fail_at_step=2, **lc),
              device="cpu", mesh=mesh, rules=rules)
    again = train(cfg, BATCH, SEQ, LoopConfig(ckpt_dir=str(tmp_path / "b"), **lc),
                  device="cpu", mesh=mesh, rules=rules)
    assert again["losses"] == whole["losses"][2:]
    for (pa, a), (pb, b) in zip(whole["params"].named_parameters(),
                                again["params"].named_parameters()):
        assert pa == pb and torch.equal(a, b), pa
    assert_equal_trees(again["opt_state"], whole["opt_state"])
    sd = optim.get(cfg.optimizer).state_defs(api.param_defs(cfg))
    step, trees = ckpt.restore(str(tmp_path / "a"), {"params": api.build_model(cfg, "cpu"),
                                                     "opt_state": sd}, device="cpu")
    assert step == 4
    for (pa, a), (pb, b) in zip(sorted_leaves(api.to_reference(trees["params"])),
                                sorted_leaves(api.to_reference(whole["params"]))):
        assert pa == pb and np.array_equal(a, b), pa
    for (p, pd), (q, t) in zip(sorted_leaves(sd), sorted_leaves(trees["opt_state"])):
        assert p == q and tuple(t.shape) == tuple(pd.shape), p
    assert_equal_trees(optim.local_state(whole["params"], trees["opt_state"]),
                       whole["opt_state"])
    # restore(mesh=, pspecs=): the state placed by the FSDP specs, then held
    pspecs = {"opt_state": shd.tree_pspecs(sd, rules, mesh)}
    _, placed = ckpt.restore(str(tmp_path / "a"), {"opt_state": sd}, mesh=mesh, pspecs=pspecs,
                             device="cpu")
    assert_equal_trees(optim.from_placed(whole["params"], placed["opt_state"], mesh,
                                         pspecs["opt_state"]), whole["opt_state"])


def test_launch_train_smoke_with_fsdp_rules(monkeypatch, capsys):
    """``launch.train --arch deepseek-7b --smoke`` with the config's FSDP
    kept (the reduced config drops it) trains the FSDP GSPMD step on 4
    simulated ranks: the model holds a quarter of every split leaf, and
    the losses are the unsharded run's (the reduced config as it is) to
    float32 rounding."""
    from repro_torch.launch import train as launch
    from repro_torch.train import loop

    reduced = configs.reduced
    monkeypatch.setattr(configs, "reduced", lambda c: dataclasses.replace(reduced(c),
                                                                          fsdp=c.fsdp))
    seen = []
    real = loop.train

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(loop, "train", spy)
    args = ["--arch", "deepseek-7b", "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ranks", "4"]
    assert launch.main(args) == 0
    model = seen[0]["params"]
    assert model.fsdp is not None and model.fsdp.size == 4
    for _, _, prms in api.param_leaves(model):
        if prms[0].fsdp_dim is not None:
            assert prms[0].shape[0] == 4
    monkeypatch.setattr(configs, "reduced", reduced)  # the reduced config: no FSDP
    assert launch.main(args) == 0
    assert seen[1]["params"].fsdp is None
    np.testing.assert_allclose(seen[0]["losses"], seen[1]["losses"], rtol=1e-5)


@pytest.mark.parametrize("mesh", [SimMesh((2, 2, 2), ("pod", "data", "model")),
                                  SimMesh((2, 4), ("pod", "data"))],
                         ids=["pod2_data2_model2", "pod2_data4"])
def test_pod_and_data_axes(mesh):
    """FSDP over both batch axes (``rules.fsdp`` is ``("pod", "data")``):
    each split leaf holds the pod x data ranks' blocks, pod-major, as
    ``place`` lays the spec's entry out; serving and the gradient are the
    model without FSDP's (tensor-parallel on the model axis, else
    unsharded) bit for bit, each record the byte model's."""
    cfg = cfg_of("deepseek-7b", remat=True)
    batch = batch_of(cfg)
    rules = rules_for_mesh(mesh, fsdp=True)
    assert rules.fsdp == ("pod", "data")
    base_rules = rules_for_mesh(mesh) if "model" in mesh.axis_names else None
    base_mesh = mesh if base_rules else None
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    base = api.init_params(cfg, 0, device="cpu", rules=base_rules, mesh=base_mesh)
    data = SimMesh(tuple(mesh.shape[a] for a in rules.fsdp), rules.fsdp)
    assert model.fsdp.size == data.ranks
    tok = shd.place(api.from_numpy(api.to_reference(base)["embed"]["tok"]),
                    (None, rules.fsdp), data)  # [pod x data, vocab, d / (pod x data)]
    if model.tp is not None:  # model rank 0's rows of the vocabulary
        assert torch.equal(model.embed.tok[:, 0], tok[:, :cfg.padded_vocab // model.tp.size])
    else:
        assert torch.equal(model.embed.tok, tok)
    assert_equal_trees(serve(cfg, model, rules, mesh, batch)[1],
                       serve(cfg, base, base_rules, base_mesh, batch)[1])
    ga = step_mod._grads_of(api.train_loss_fn(cfg, base_rules, base_mesh), base, batch, 1)[1]
    model.fsdp.reset()
    gb = step_mod._grads_of(api.train_loss_fn(cfg, rules, mesh), model, batch, 1)[1]
    assert_equal_trees(api.global_leaves(model, gb), api.global_leaves(base, ga))
    assert_records(model, lm.fsdp_calls(cfg, "train", mesh, rules), "mesh8", ordered=False)
