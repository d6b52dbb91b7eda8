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
from repro.train import optim as ref_optim, step as ref_step
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api, lm
from repro_torch.train import optim, step as step_mod
from test_torch_lm_common import reduced, to_numpy
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


def step_reference(mesh_dm, kind):
    """A memo of the reference's runs of the ``kind`` step (``gspmd``:
    ``build_train_step(mesh=, rules=)``; ``butterfly``:
    ``build_train_step_butterfly``) on ``mesh_dm``: for an arch, its config,
    weights, batch, the metrics of steps 1-3 and the parameters after
    them."""
    memo = {}
    rules = ref_rules(mesh_dm)

    def run(arch):
        if arch in memo:
            return memo[arch]
        ref_cfg, cfg = configs_of(arch)
        params = ref_params(ref_cfg)
        fn = jax.jit(ref_step.build_train_step(ref_cfg, mesh=mesh_dm, rules=rules, lr_kw=LR_KW)
                     if kind == "gspmd" else
                     ref_step.build_train_step_butterfly(ref_cfg, mesh_dm, rules, lr_kw=LR_KW))
        batch = tokens(cfg)
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
        for s in STEPS:
            p, st, m = fn(*jax.device_put((p, st), layout), rows, jnp.int32(s))
            metrics.append({k: float(v) for k, v in m.items()})
        memo[arch] = (cfg, params, batch, metrics, jax.tree.map(np.asarray, p))
        return memo[arch]

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


def check_steps(reference, arch, kind):
    """Steps 1-3 of the port's sharded ``kind`` step against the
    reference's: loss within 1e-5; ``grad_norm`` and the gathered
    parameters within the gradients' tolerance (AdamW's ill-conditioned
    elements held to the update's bound); step 1's gradient equal to the
    unsharded port's; each step's model-axis collectives equal to the byte
    model, and (butterfly) each rank's bytes to it plus the data-axis
    sync's byte model."""
    cfg, params, batch, want, want_params = reference(arch)
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
