"""Shared helpers of the tensor-parallel parity tests
(``test_torch_tp_*.py``): the same seeded weights and batches through the
JAX package on ``mesh_dm`` (data 2 x model 4; parameters placed with
``NamedSharding`` from ``rules_for_mesh(mesh_dm)``, inputs sharded over
``data``, every step jitted on the conftest's 8 host devices) and through
the port sharded over ``SimMesh((2, 4), ("data", "model"))``, on the CPU
in float32.

The six reduced dense and MoE configs put 4 query heads and 2 kv heads
on the 4-way model axis: the heads split, the kv heads fall back to
replicated (``wk``/``wv`` whole on every rank). ``KV_SPLIT`` adds the
split-kv and padded-vocabulary case (4 kv heads, vocab 500 padded to 512,
the dead columns in the last shard).

The SSM, hybrid, VLM and encoder-decoder files (one a family, so that the
suite's workers take one each) share the ``check_*`` functions at the end:
prefill logits and cache, teacher-forced decode, greedy ``generate``, the
loss, the byte model, ``to_reference``'s round trip and a sharded
checkpoint's restore.
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
from repro_torch.checkpoint import ckpt
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh, sorted_leaves
from repro_torch.models import api, lm
from repro_torch.serve import engine
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, train
from test_torch_lm_common import assert_close, assert_tree_close, reduced, to_numpy
from test_torch_train_common import LR_KW, STEPS, as_torch, assert_adam_close, assert_trees_close

ARCHS = ("qwen3-1.7b", "olmo-1b", "gemma3-27b", "deepseek-7b", "qwen3-moe-235b-a22b",
         "kimi-k2-1t-a32b")
KV_SPLIT = ("qwen3-1.7b", dict(n_kv_heads=4, vocab=500))
MESH = SimMesh((2, 4), ("data", "model"))
RULES = rules_for_mesh(MESH)
ROWS = MESH.shape["data"]  # data groups: one rank's rows are BATCH / ROWS
SIZE = MESH.shape["model"]
BATCH, SEQ = 4, 32
# float32 on the CPU (tests/test_torch_lm_forward.py, test_torch_train_grads.py)
ATOL = RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 5e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's sharded passes on the CPU are many small ops: one intra-op
    thread a module (restored after) keeps them from contending with the
    reference's 8 host devices and the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs_of(arch, changes=None):
    """(reference config, port config) of ``arch`` reduced, with ``changes``."""
    return reduced(arch, **(changes or {}))


def ref_params(ref_cfg, seed=0):
    return ref_api.init_params(ref_cfg, jax.random.PRNGKey(seed))


def ref_rules(mesh_dm):
    return ref_shd.rules_for_mesh(mesh_dm)


def place_params(ref_cfg, params, mesh_dm):
    """The reference's parameters on ``mesh_dm`` by its specs."""
    specs = ref_shd.tree_pspecs(ref_api.param_defs(ref_cfg), ref_rules(mesh_dm), mesh_dm)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh_dm, s)),
                        params, specs)


def place_rows(tree, mesh_dm):
    """Batch inputs (numpy, rows first) sharded over ``data``."""
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh_dm, P("data")))
            for k, v in tree.items()}


def port_sharded(cfg, params):
    """The port's model of ``cfg`` carrying the reference's weights, sharded
    over ``MESH``'s model axis."""
    return api.from_reference(cfg, to_numpy(params), device="cpu", rules=RULES, mesh=MESH)


def tokens(cfg, rows=BATCH, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)}


def inputs(cfg, rows=BATCH, seq=SEQ, seed=0):
    """:func:`tokens` (``seq`` text tokens) and the family's other inputs:
    the VLM's patches (before the text), whisper's frames."""
    out = tokens(cfg, rows, seq, seed)
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(rows, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(rows, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def step_reference(mesh_dm, kind):
    """A memo of the reference's runs of the ``kind`` step (``gspmd``:
    ``build_train_step(mesh=, rules=)``; ``butterfly``:
    ``build_train_step_butterfly``) on ``mesh_dm``: for an arch, its config,
    weights, batch, the metrics of steps 1-3 and the parameters after
    them; ``trajectories[key]`` the parameters and optimizer state before
    each step and after the last (numpy)."""
    memo = {}
    rules = ref_rules(mesh_dm)

    def run(arch, changes=None):
        key = (arch, tuple(sorted((changes or {}).items())))
        if key in memo:
            return memo[key]
        ref_cfg, cfg = configs_of(arch, changes)
        params = ref_params(ref_cfg)
        fn = jax.jit(ref_step.build_train_step(ref_cfg, mesh=mesh_dm, rules=rules, lr_kw=LR_KW)
                     if kind == "gspmd" else
                     ref_step.build_train_step_butterfly(ref_cfg, mesh_dm, rules, lr_kw=LR_KW))
        batch = inputs(cfg)
        p = place_params(ref_cfg, params, mesh_dm)
        opt = ref_optim.get(ref_cfg.optimizer)
        sspecs = ref_shd.tree_pspecs(opt.state_defs(ref_api.param_defs(ref_cfg)), rules,
                                     mesh_dm)
        st = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh_dm, sp)),
                          opt.init(params), sspecs)
        rows = place_rows(batch, mesh_dm)
        # every step's inputs laid out as the first's: one compile
        layout = jax.tree.map(lambda a: a.sharding, (p, st))
        metrics = []
        path = [(params, jax.tree.map(np.asarray, st))]
        for s in STEPS:
            p, st, m = fn(*jax.device_put((p, st), layout), rows, jnp.int32(s))
            metrics.append({k: float(v) for k, v in m.items()})
            path.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, st)))
        run.trajectories[key] = path
        memo[key] = (cfg, params, batch, metrics, jax.tree.map(np.asarray, p))
        return memo[key]

    run.trajectories = {}
    return run


def port_step(cfg, kind):
    if kind == "gspmd":
        return step_mod.build_train_step(cfg, mesh=MESH, rules=RULES, lr_kw=LR_KW)
    return step_mod.build_train_step_butterfly(cfg, MESH, RULES, lr_kw=LR_KW)


def leaf_splits(cfg):
    """(PD, model-axis split) of every parameter leaf."""
    for _, pd in shd.tree_leaves_with_path(api.param_defs(cfg)):
        spec = shd.spec_for(pd, RULES, MESH)
        yield pd, SIZE if any(e is not None for e in spec) else 1


def check_steps(reference, arch, kind, changes=None):
    """Steps 1-3 of the port's sharded ``kind`` step against the
    reference's: loss within 1e-5; ``grad_norm`` and the gathered
    parameters within the gradients' tolerance (AdamW's ill-conditioned
    elements held to the update's bound); step 1's gradient equal to the
    unsharded port's; each step's model-axis collectives equal to the byte
    model, and (butterfly) each rank's bytes to it plus the data-axis
    sync's byte model."""
    cfg, params, batch, want, want_params = reference(arch, changes)
    model = port_sharded(cfg, params)
    state = optim.get(cfg.optimizer).init(model)
    fn = port_step(cfg, kind)
    calls = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE) + optim.tp_calls(model)
    tb = as_torch(batch)
    grads = []
    for s, w in zip(STEPS, want):
        grads.append(api.global_leaves(model, step_mod._grads_of(
            api.train_loss_fn(cfg, RULES, MESH), model, tb, 1)[1]))
        if s == STEPS[0]:
            plain = api.from_reference(cfg, to_numpy(params), device="cpu")
            _, g0 = step_mod._grads_of(api.train_loss_fn(cfg), plain, tb, 1)
            assert_trees_close(grads[-1], g0, GRAD_RTOL, GRAD_ATOL, f"{arch} gradient")
        model.tp.reset()
        model, state, m = fn(model, state, tb, s)
        assert abs(float(m["loss"]) - w["loss"]) <= 1e-5, (float(m["loss"]), w["loss"])
        assert float(m["grad_norm"]) == pytest.approx(w["grad_norm"], rel=GRAD_RTOL)
        assert m["lr"] == pytest.approx(w["lr"], rel=1e-6) and m["lr"] > 0
        assert model.tp.stats == lm.tp_stats(calls, SIZE), s
        if kind == "butterfly":
            assert float(m["rank_spread"]) == 0.0
            from repro_torch.core import collectives
            sync = sum(collectives.grad_sync_bytes(
                "butterfly", (ROWS,), 2, int(np.prod(pd.shape)) // split, 4)
                for pd, split in leaf_splits(cfg))
            assert m["bytes_per_rank"] == sync + sum((SIZE - 1) * b for _, b in calls)
    got = api.to_reference(model)
    # parameters: AdamW's g / (sqrt(v) + eps) turns a gradient's float32
    # rounding into a visible share of a step where the moments nearly
    # cancel; PARAM_ATOL bounds it at 1e-3 of the steps' lr sum
    if cfg.optimizer == "adamw":
        lr_sum = sum(w["lr"] for w in want)
        assert_adam_close(got, want_params, grads, lr_sum, GRAD_RTOL, PARAM_ATOL,
                          f"{arch} {kind}")
    else:
        assert_trees_close(got, want_params, GRAD_RTOL, PARAM_ATOL, f"{arch} {kind}")


# ---------------------------------------------------------------------------
# The family files' checks (test_torch_tp_{ssm,hybrid,vlm,encdec}.py)
# ---------------------------------------------------------------------------

PROMPT = SEQ - 4
DECODE_STEPS = 4
NEW = 4  # PROMPT + NEW == SEQ: the teacher-forced steps' cache shape


def case_id(arch, changes):
    return arch if not changes else arch + "-" + "-".join(f"{k}{v}" for k, v in changes.items())


def _extras(data, rows=None):
    return {k: v if rows is None else v[rows] for k, v in data.items()
            if k in ("patches", "frames")}


def serve_reference(mesh_dm):
    """A memo of the reference's serving runs on ``mesh_dm``: for an arch
    and config changes, the port's config and the weights, inputs, the
    prefill's logits and cache, ``DECODE_STEPS`` teacher-forced decode
    steps' logits and ``NEW`` greedy tokens (the reference's generate loop
    with its jitted prefill and decode, compiled once)."""
    memo = {}

    def run(arch, changes=None):
        key = (arch, tuple(sorted((changes or {}).items())))
        if key in memo:
            return memo[key]
        ref_cfg, cfg = configs_of(arch, changes)
        params = ref_params(ref_cfg)
        placed = place_params(ref_cfg, params, mesh_dm)
        rules = ref_rules(mesh_dm)
        data = inputs(cfg)
        ins = place_rows(dict(_extras(data), tokens=data["tokens"][:, :PROMPT]), mesh_dm)
        prefill = jax.jit(ref_api.prefill_fn(ref_cfg, rules, mesh_dm))
        logits, cache, pos = prefill(placed, ins)
        pos = int(pos)
        out = {"params": params, "data": data, "prefill": np.asarray(logits),
               "cache": jax.tree.map(np.asarray, cache), "pos": pos}
        grown = ref_engine.prepare_decode_cache(ref_cfg, cache, pos, pos + NEW)
        decode = jax.jit(ref_api.decode_fn(ref_cfg, rules, mesh_dm))
        layout = jax.tree.map(lambda a: a.sharding, grown)
        c, steps = grown, []
        for i in range(DECODE_STEPS):
            tok = jnp.asarray(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            dl, c = decode(placed, jax.device_put(c, layout), tok, jnp.int32(pos + i))
            steps.append(np.asarray(dl))
        out["decode"] = steps
        toks = [ref_engine.sample(logits, None)]
        c = grown
        for i in range(NEW - 1):
            dl, c = decode(placed, jax.device_put(c, layout), toks[-1][:, None],
                           jnp.int32(pos + i))
            toks.append(ref_engine.sample(dl, None))
        out["generate"] = np.stack([np.asarray(t) for t in toks], 1)
        memo[key] = (cfg, out)
        return memo[key]

    return run


def _prefill_inputs(ref):
    data = ref["data"]
    return dict(as_torch(_extras(data)), tokens=torch.from_numpy(data["tokens"][:, :PROMPT]))


def check_prefill(reference, arch, changes=None):
    """The sharded prefill's logits and cache (in the reference's layout)
    against the reference's; its calls and each rank's bytes the byte
    model's; the held cache round-trips bit for bit."""
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    with torch.no_grad():
        logits, cache, pos = api.prefill_fn(cfg, RULES, MESH)(model, _prefill_inputs(ref))
    assert pos == ref["pos"] and logits.shape == (BATCH, cfg.padded_vocab)
    assert_close(logits, ref["prefill"], ATOL, RTOL, "prefill logits")
    whole = api.global_cache(model, cache)
    assert_tree_close(whole, ref["cache"], ATOL, RTOL)
    for (pa, a), (pb, b) in zip(sorted_leaves(api.held_cache(model, whole)),
                                sorted_leaves(cache)):
        assert pa == pb and torch.equal(a, b), pa
    want = lm.tp_calls(cfg, "prefill", BATCH // ROWS, PROMPT, SIZE)
    assert list(model.tp.calls) == want
    assert model.tp.stats == lm.tp_stats(want, SIZE)
    assert list(model.tp.bytes_sent) == [sum((SIZE - 1) * b for _, b in want)] * MESH.ranks


def check_decode(reference, arch, changes=None):
    """``DECODE_STEPS`` teacher-forced decode steps after the sharded
    prefill against the reference's; each step's calls the byte model's."""
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    data = ref["data"]
    with torch.no_grad():
        _, cache, pos = api.prefill_fn(cfg, RULES, MESH)(model, _prefill_inputs(ref))
        cache = engine.prepare_decode_cache(cfg, cache, pos, pos + NEW)
        decode = api.decode_fn(cfg, RULES, MESH)
        want = lm.tp_calls(cfg, "decode", BATCH // ROWS, SEQ, SIZE)
        for i in range(DECODE_STEPS):
            model.tp.reset()
            tok = torch.from_numpy(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            logits, cache = decode(model, cache, tok, pos + i)
            assert_close(logits, ref["decode"][i], ATOL, RTOL, f"decode step {i}")
            assert list(model.tp.calls) == want


def check_generate(reference, arch, changes=None):
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    ins = _prefill_inputs(ref)
    got = engine.generate(cfg, model, ins.pop("tokens"), NEW, extra_inputs=ins,
                          rules=RULES, mesh=MESH)
    np.testing.assert_array_equal(got.tokens, ref["generate"])


def check_loss(reference, arch, changes=None):
    """The sharded loss against the reference's GSPMD step's first loss of
    the same weights and batch (within 1e-5); the forward's calls the byte
    model's first."""
    cfg, params, batch, want, _ = reference(arch, changes)
    model = port_sharded(cfg, params)
    with torch.no_grad():
        loss = api.train_loss_fn(cfg, RULES, MESH)(model, as_torch(batch))
    assert abs(float(loss) - want[0]["loss"]) <= 1e-5, (float(loss), want[0]["loss"])
    calls = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE)
    assert list(model.tp.calls) == calls[:len(model.tp.calls)]


def check_round_trip(arch, changes=None):
    """``to_reference`` of the sharded model is the unsharded one's bit for
    bit; the reference tree loads back into the same held blocks; without
    a model axis nothing changes (a data-only mesh computes what no mesh
    computes, and refuses no unsharded model)."""
    _, cfg = configs_of(arch, changes)
    plain = api.init_params(cfg, 0, device="cpu")
    sharded = api.shard(plain, RULES, MESH)
    tree = api.to_reference(sharded)
    for (pa, a), (pb, b) in zip(sorted_leaves(api.to_reference(plain)), sorted_leaves(tree)):
        assert pa == pb and np.array_equal(a, b), pa
    again = api.from_reference(cfg, tree, device="cpu", rules=RULES, mesh=MESH)
    for (pa, a), (pb, b) in zip(sharded.named_parameters(), again.named_parameters()):
        assert pa == pb and torch.equal(a, b), pa
    data = as_torch(inputs(cfg))
    data_mesh = SimMesh(2)
    rules = rules_for_mesh(data_mesh)
    with torch.no_grad():
        a = api.prefill_fn(cfg)(plain, data)
        b = api.prefill_fn(cfg, rules, data_mesh)(plain, data)
        assert torch.equal(a[0], b[0]) and a[2] == b[2]
        assert torch.equal(api.train_loss_fn(cfg)(plain, data),
                           api.train_loss_fn(cfg, rules, data_mesh)(plain, data))


def check_checkpoint(tmp_path, arch, changes=None):
    """The loop trains the sharded model 2 steps as the unsharded one; its
    checkpoint restores bit-equal onto the same mesh (parameters and
    optimizer state) and into the unsharded model."""
    _, cfg = configs_of(arch, changes)
    seq = SEQ + (cfg.n_patches if cfg.family == "vlm" else 0)
    lc = dict(n_steps=2, ckpt_every=2, async_ckpt=False, lr_kw=LR_KW)
    plain = train(cfg, BATCH, seq, LoopConfig(ckpt_dir=str(tmp_path / "a"), **lc), device="cpu")
    run = train(cfg, BATCH, seq, LoopConfig(ckpt_dir=str(tmp_path / "b"), **lc), device="cpu",
                mesh=MESH)
    assert run["losses"] == pytest.approx(plain["losses"], abs=1e-5)
    sd = optim.get(cfg.optimizer).state_defs(api.param_defs(cfg))
    tp = api.tensor_parallel(RULES, MESH, "cpu")
    step, trees = ckpt.restore(str(tmp_path / "b"), {"params": api.build_model(cfg, "cpu", tp),
                                                     "opt_state": sd}, device="cpu")
    assert step == 2
    model = trees["params"]
    for (pa, a), (pb, b) in zip(model.named_parameters(), run["params"].named_parameters()):
        assert pa == pb and torch.equal(a, b), pa
    state = optim.local_state(model, trees["opt_state"])
    for (p, x), (_, z) in zip(sorted_leaves(state), sorted_leaves(run["opt_state"])):
        assert torch.equal(x, z), p
    _, whole = ckpt.restore(str(tmp_path / "b"), {"params": api.build_model(cfg, "cpu")},
                            device="cpu")
    for (pa, a), (pb, b) in zip(sorted_leaves(api.to_reference(whole["params"])),
                                sorted_leaves(api.to_reference(run["params"]))):
        assert pa == pb and np.array_equal(a, b), pa


def check_each_step(reference, arch, kind, changes=None):
    """:func:`check_steps` with each of steps 1-3 taken from the reference's
    parameters and optimizer state before it: the loss, ``grad_norm``, the
    record and the parameters after the step against the reference's
    (AdamW's ill-conditioned elements of that step's gradient held to its
    bound, :func:`assert_adam_close`). For a model whose gradient has so
    many elements under ``ILL_CONDITIONED`` that three steps compound them
    past the 1 % that helper admits (whisper's)."""
    cfg, _, batch, want, _ = reference(arch, changes)
    path = reference.trajectories[(arch, tuple(sorted((changes or {}).items())))]
    fn = port_step(cfg, kind)
    tb = as_torch(batch)
    for i, (s, w) in enumerate(zip(STEPS, want)):
        params, st = path[i]
        model = port_sharded(cfg, params)
        state = optim.local_state(model, shd.tree_map(
            lambda a: torch.from_numpy(np.array(a)), st))
        calls = lm.tp_calls(cfg, "train", BATCH // ROWS, SEQ, SIZE) + optim.tp_calls(model)
        grad = api.global_leaves(model, step_mod._grads_of(
            api.train_loss_fn(cfg, RULES, MESH), model, tb, 1)[1])
        model.tp.reset()
        model, state, m = fn(model, state, tb, s)
        assert abs(float(m["loss"]) - w["loss"]) <= 1e-5, (s, float(m["loss"]), w["loss"])
        assert float(m["grad_norm"]) == pytest.approx(w["grad_norm"], rel=GRAD_RTOL)
        assert m["lr"] == pytest.approx(w["lr"], rel=1e-6) and m["lr"] > 0
        assert model.tp.stats == lm.tp_stats(calls, SIZE), s
        assert_adam_close(api.to_reference(model), path[i + 1][0], [grad], w["lr"], GRAD_RTOL,
                          PARAM_ATOL, f"{arch} {kind} step {s}")
