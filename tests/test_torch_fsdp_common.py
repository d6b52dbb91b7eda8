"""Shared helpers of the FSDP (ZeRO-3) parity tests
(``test_torch_fsdp_*.py``): the same seeded weights and batches through
the JAX package with ``rules_for_mesh(mesh, fsdp=True)`` (parameters and
optimizer state placed by its FSDP specs, inputs sharded over ``data``,
every step jitted on the conftest's 8 host devices) on ``mesh_dm`` (data
2 x model 4) and ``mesh8`` (data 8), and through the port built with the
same rules on ``SimMesh((2, 4), ("data", "model"))`` and ``SimMesh(8)``,
on the CPU in float32 at the tolerances of ``test_torch_tp_common``.

Every FSDP record the port takes is held to the byte model
(``lm.fsdp_calls``, plus ``optim.fsdp_calls`` for a whole step), and a
model-axis record to ``lm.tp_calls`` as before.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.dist import sharding as ref_shd
from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro.train import optim as ref_optim, step as ref_step
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh, sorted_leaves
from repro_torch.models import api, lm
from repro_torch.serve import engine
from repro_torch.train import optim, step as step_mod
from test_torch_lm_common import assert_close, assert_tree_close, to_numpy
from test_torch_tp_common import (ATOL, GRAD_ATOL, GRAD_RTOL, PARAM_ATOL, RTOL, configs_of,
                                  inputs, one_torch_thread, ref_params)  # noqa: F401
from test_torch_train_common import (LR_KW, STEPS, as_torch, assert_adam_close,
                                     assert_trees_close)

#: the port's mesh of each reference mesh fixture
MESHES = {"mesh_dm": SimMesh((2, 4), ("data", "model")), "mesh8": SimMesh(8)}
BATCH, SEQ = 8, 32  # 8 rows: one a data rank on mesh8
PROMPT = SEQ - 4
DECODE_STEPS = 4
NEW = 4


def rules_of(name):
    return rules_for_mesh(MESHES[name], fsdp=True)


def data_size(name):
    return MESHES[name].shape["data"]


def reference(request_mesh, name):
    """A memo of the reference's FSDP runs on one mesh: for an arch, the
    port's config, the weights, the inputs, the prefill's logits and
    cache, ``DECODE_STEPS`` teacher-forced decode steps' logits, ``NEW``
    greedy tokens, the metrics of GSPMD steps 1-3 and the parameters and
    optimizer state after them (numpy)."""
    memo = {}
    rules = ref_shd.rules_for_mesh(request_mesh, fsdp=True)

    def put(tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(request_mesh, s)),
                            tree, specs)

    def rows(tree):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(request_mesh, P("data")))
                for k, v in tree.items()}

    def run(arch):
        if arch in memo:
            return memo[arch]
        ref_cfg, cfg = configs_of(arch)
        params = ref_params(ref_cfg)
        pdefs = ref_api.param_defs(ref_cfg)
        placed = put(params, ref_shd.tree_pspecs(pdefs, rules, request_mesh))
        data = inputs(cfg, BATCH, SEQ)
        extras = {k: v for k, v in data.items() if k in ("patches", "frames")}
        out = {"params": params, "data": data}
        logits, cache, pos = jax.jit(ref_api.prefill_fn(ref_cfg, rules, request_mesh))(
            placed, rows(dict(extras, tokens=data["tokens"][:, :PROMPT])))
        pos = int(pos)
        out.update(prefill=np.asarray(logits), cache=jax.tree.map(np.asarray, cache), pos=pos)
        grown = ref_engine.prepare_decode_cache(ref_cfg, cache, pos, pos + NEW)
        decode = jax.jit(ref_api.decode_fn(ref_cfg, rules, request_mesh))
        layout = jax.tree.map(lambda a: a.sharding, grown)
        c, steps = grown, []
        for i in range(DECODE_STEPS):
            tok = jnp.asarray(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            dl, c = decode(placed, jax.device_put(c, layout), tok, jnp.int32(pos + i))
            steps.append(np.asarray(dl))
        out["decode"] = steps
        toks, c = [ref_engine.sample(logits, None)], grown
        for i in range(NEW - 1):
            dl, c = decode(placed, jax.device_put(c, layout), toks[-1][:, None],
                           jnp.int32(pos + i))
            toks.append(ref_engine.sample(dl, None))
        out["generate"] = np.stack([np.asarray(t) for t in toks], 1)
        opt = ref_optim.get(ref_cfg.optimizer)
        st = put(opt.init(params), ref_shd.tree_pspecs(opt.state_defs(pdefs), rules,
                                                        request_mesh))
        fn = jax.jit(ref_step.build_train_step(ref_cfg, mesh=request_mesh, rules=rules,
                                               lr_kw=LR_KW))
        layout = jax.tree.map(lambda a: a.sharding, (placed, st))
        p, batch, metrics = placed, rows(data), []
        for s in STEPS:
            p, st, m = fn(*jax.device_put((p, st), layout), batch, jnp.int32(s))
            metrics.append({k: float(v) for k, v in m.items()})
        out.update(metrics=metrics, after=jax.tree.map(np.asarray, p),
                   state=jax.tree.map(np.asarray, st))
        memo[arch] = (cfg, out)
        return memo[arch]

    return run


def port_model(cfg, params, name):
    """The port's model of ``cfg`` carrying the reference's weights, built
    with FSDP rules on mesh ``name``."""
    return api.from_reference(cfg, to_numpy(params), device="cpu", rules=rules_of(name),
                              mesh=MESHES[name])


def prefill_inputs(out):
    data = out["data"]
    ins = {k: torch.from_numpy(v) for k, v in data.items() if k in ("patches", "frames")}
    return dict(ins, tokens=torch.from_numpy(data["tokens"][:, :PROMPT]))


def assert_records(model, calls, name, ordered=True):
    """The model's FSDP record against the byte model's ``calls`` (every
    call, in order unless ``ordered`` is False) and each rank's bytes
    against their wire bytes."""
    fs = model.fsdp
    have, want = list(fs.calls), list(calls)
    if not ordered:
        have, want = sorted(have), sorted(want)
    assert have == want
    stats = lm.tp_stats(calls, fs.size)
    assert fs.stats == stats
    wire = sum(v["wire_bytes"] for v in stats.values())
    assert list(fs.bytes_sent) == [wire] * MESHES[name].ranks


def check_prefill(ref, arch, name):
    """The FSDP prefill's logits and cache against the reference's; its
    calls and each rank's bytes the byte model's."""
    cfg, out = ref(arch)
    model = port_model(cfg, out["params"], name)
    with torch.no_grad():
        logits, cache, pos = api.prefill_fn(cfg, rules_of(name), MESHES[name])(
            model, prefill_inputs(out))
    assert pos == out["pos"] and logits.shape == (BATCH, cfg.padded_vocab)
    assert_close(logits, out["prefill"], ATOL, RTOL, "prefill logits")
    assert_tree_close(api.global_cache(model, cache), out["cache"], ATOL, RTOL)
    assert_records(model, lm.fsdp_calls(cfg, "prefill", MESHES[name], rules_of(name)), name)


def check_decode(ref, arch, name):
    """Teacher-forced decode steps after the FSDP prefill against the
    reference's, each step's calls the byte model's; greedy ``generate``
    equal to the reference's tokens."""
    cfg, out = ref(arch)
    model = port_model(cfg, out["params"], name)
    rules, mesh = rules_of(name), MESHES[name]
    data = out["data"]
    want = lm.fsdp_calls(cfg, "decode", mesh, rules)
    with torch.no_grad():
        _, cache, pos = api.prefill_fn(cfg, rules, mesh)(model, prefill_inputs(out))
        cache = engine.prepare_decode_cache(cfg, cache, pos, pos + NEW)
        decode = api.decode_fn(cfg, rules, mesh)
        for i in range(DECODE_STEPS):
            model.fsdp.reset()
            tok = torch.from_numpy(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            logits, cache = decode(model, cache, tok, pos + i)
            assert_close(logits, out["decode"][i], ATOL, RTOL, f"decode step {i}")
            assert_records(model, want, name)
    ins = prefill_inputs(out)
    got = engine.generate(cfg, model, ins.pop("tokens"), NEW, extra_inputs=ins, rules=rules,
                          mesh=mesh)
    np.testing.assert_array_equal(got.tokens, out["generate"])


def check_steps(ref, arch, name):
    """GSPMD steps 1-3 with FSDP against the reference's: the loss within
    1e-5, ``grad_norm`` within the gradients' tolerance, each step's FSDP
    record (gathers, remat's recompute, reduce-scatters, the clip's and
    Adafactor's all-reduces) the byte model's, then the gathered
    parameters (AdamW's ill-conditioned elements held to the update's
    bound) and the gathered optimizer state."""
    cfg, out = ref(arch)
    rules, mesh = rules_of(name), MESHES[name]
    model = port_model(cfg, out["params"], name)
    state = optim.get(cfg.optimizer).init(model)
    fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, lr_kw=LR_KW)
    batch = as_torch(out["data"])
    grads = []
    for s, w in zip(STEPS, out["metrics"]):
        grads.append(api.global_leaves(model, step_mod._grads_of(
            api.train_loss_fn(cfg, rules, mesh), model, batch, 1)[1]))
        model.fsdp.reset()
        if model.tp is not None:
            model.tp.reset()
        model, state, m = fn(model, state, batch, s)
        assert abs(float(m["loss"]) - w["loss"]) <= 1e-5, (float(m["loss"]), w["loss"])
        assert float(m["grad_norm"]) == pytest.approx(w["grad_norm"], rel=GRAD_RTOL)
        calls = lm.fsdp_calls(cfg, "train", mesh, rules) + optim.fsdp_calls(model)
        assert_records(model, calls, name, ordered=False)
        if model.tp is not None:
            tp_calls = (lm.tp_calls(cfg, "train", BATCH // data_size(name), SEQ,
                                    mesh.shape["model"]) + optim.tp_calls(model))
            assert sorted(model.tp.calls) == sorted(tp_calls)
    got = api.to_reference(model)
    if cfg.optimizer == "adamw":
        lr_sum = sum(w["lr"] for w in out["metrics"])
        assert_adam_close(got, out["after"], grads, lr_sum, GRAD_RTOL, PARAM_ATOL, arch)
    else:
        assert_trees_close(got, out["after"], GRAD_RTOL, PARAM_ATOL, arch)
    st = {p: np.asarray(v) for p, v in sorted_leaves(optim.global_state(model, state))}
    for p, want in sorted_leaves(out["state"]):
        assert st[p].shape == np.asarray(want).shape, p
        np.testing.assert_allclose(st[p], np.asarray(want), rtol=1e-3, atol=GRAD_ATOL,
                                   err_msg="/".join(p))


def check_loss(ref, arch, name):
    """The FSDP loss against the reference's first step's loss (1e-5); the
    forward's gathers are the byte model's first calls."""
    cfg, out = ref(arch)
    model = port_model(cfg, out["params"], name)
    with torch.no_grad():
        loss = api.train_loss_fn(cfg, rules_of(name), MESHES[name])(model, as_torch(out["data"]))
    assert abs(float(loss) - out["metrics"][0]["loss"]) <= 1e-5
    calls = lm.fsdp_calls(cfg, "train", MESHES[name], rules_of(name))
    assert list(model.fsdp.calls) == calls[:len(model.fsdp.calls)]
    assert all(k == "all-gather" for k, _ in model.fsdp.calls)


def check_layout(arch, name):
    """Seeded FSDP leaves: each held leaf is the block ``shd.held_block``
    gives it (with the held data and model ranks in front), and gathered
    they are the unsharded seeded tree bit for bit (the port's
    ``tree_init``); the reference tree loads back into the same blocks."""
    _, cfg = configs_of(arch)
    rules, mesh = rules_of(name), MESHES[name]
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    want = shd.tree_init(api.param_defs(cfg), 0, cfg.param_dtype, "cpu")
    split = 0
    for path, lead, prms in api.param_leaves(model):
        pd = shd.tree_get(api.param_defs(cfg), path)
        nl = len(lead)
        block, f = shd.held_block(shd.PD(pd.shape[nl:], pd.logical[nl:]), rules, mesh)
        m = None if model.tp is None else model.tp.split_dim(
            shd.PD(pd.shape[nl:], pd.logical[nl:]))
        held = ((mesh.shape["data"],) if f is not None else ()) + (
            (mesh.shape["model"],) if m is not None else ())
        assert tuple(prms[0].shape) == held + block, path
        assert prms[0].fsdp_dim == f and prms[0].tp_dim == m, path
        split += f is not None
    assert split > 0
    tree = api.to_reference(model)
    for (pa, a), (pb, b) in zip(sorted_leaves(tree), sorted_leaves(want)):
        assert pa == pb and np.array_equal(a, api.to_numpy(b)), pa
    again = api.from_reference(cfg, tree, device="cpu", rules=rules, mesh=mesh)
    for (pa, a), (pb, b) in zip(model.named_parameters(), again.named_parameters()):
        assert pa == pb and torch.equal(a, b), pa
