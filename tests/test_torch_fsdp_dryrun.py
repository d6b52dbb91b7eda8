"""The dry run with FSDP rules (``repro_torch.launch.dryrun``): the record
``tp_step_stats`` takes of a reduced FSDP step under fake tensors, on
(data 2, model 4) and on data 8, equals a real step's records (the
``FullyShardedData``'s and the ``TensorParallel``'s) and the byte models
(``lm.fsdp_calls`` + ``optim.fsdp_calls``, ``lm.tp_calls`` +
``optim.tp_calls``) for every FSDP family; the gradient sync leaves out
the leaves FSDP splits (their reduce-scatter is the step's); and the
remaining difference against the reference's HLO count, pinned."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.models import api, lm
from repro_torch.train import optim, step as step_mod
from test_torch_tp_common import one_torch_thread  # noqa: F401

FSDP_ARCHS = ("deepseek-7b", "gemma3-27b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
              "internvl2-26b", "jamba-v0.1-52b")
MESHES = (SimMesh((2, 4), ("data", "model")), SimMesh(8))
BATCH, SEQ = 8, 32


def _real_records(cfg, shape, mesh, rules):
    """The records of one real reduced step of ``shape``'s kind."""
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    ins = shd.tree_map(lambda pd: torch.zeros(pd.shape, dtype=shd.resolve_dtype(pd, "float32")),
                       api.input_defs(cfg, shape))
    with torch.no_grad():
        if shape.kind == "prefill":
            api.prefill_fn(cfg, rules, mesh)(model, ins)
        elif shape.kind == "decode":
            cache = api.held_cache(model, shd.tree_map(lambda pd: torch.zeros(pd.shape),
                                                       api.cache_defs(cfg, shape)))
            api.decode_fn(cfg, rules, mesh)(model, cache, ins["token"], SEQ - 1)
    if shape.kind == "train":
        fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules)
        fn(model, optim.get(cfg.optimizer).init(model), ins, 0)
    return model


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_record_equals_a_real_step(arch, kind):
    """The dry run's record of a reduced FSDP step (remat on) equals the
    real step's FSDP and model-axis records, and the byte models."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), remat=True)
    shape = ShapeConfig("cell", SEQ, BATCH, kind)
    text = SEQ - (cfg.n_patches if cfg.family == "vlm" else 0)
    for mesh in MESHES:
        rules = rules_for_mesh(mesh, fsdp=True)
        got = dryrun.tp_step_stats(cfg, shape, mesh, rules)
        model = _real_records(cfg, shape, mesh, rules)
        parts = [model.fsdp.stats] + ([model.tp.stats] if model.tp is not None else [])
        assert got == hlo_stats.total_stats(parts)
        train = kind == "train"
        fcalls = lm.fsdp_calls(cfg, kind, mesh, rules) + (optim.fsdp_calls(model) if train
                                                          else [])
        want = [lm.tp_stats(fcalls, mesh.shape["data"])]
        if model.tp is not None:
            size = mesh.shape["model"]
            tcalls = lm.tp_calls(cfg, kind, BATCH // mesh.shape["data"], text, size) + (
                optim.tp_calls(model) if train else [])
            want.append(lm.tp_stats(tcalls, size))
        assert got == hlo_stats.total_stats(want)
        assert got["all-gather"]["count"] > 0
        assert (got["reduce-scatter"]["count"] > 0) == train


def test_grad_sync_leaves_out_what_fsdp_splits():
    """With FSDP rules the train row's gradient sync (``xla``: one
    all-reduce a leaf) counts only the leaves FSDP keeps whole over the
    data axes, each at its model-axis shard's bytes: the split leaves'
    sync is the step's reduce-scatter, counted once by the step's
    record."""
    cfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"))
    mesh = MESHES[0]
    rules, plain = rules_for_mesh(mesh, fsdp=True), rules_for_mesh(mesh)
    got = dryrun.grad_sync_stats(cfg, mesh, rules, "xla", 2)
    whole = dryrun.grad_sync_stats(cfg, mesh, plain, "xla", 2)
    kept = split = 0
    nbytes = 0.0
    for _, pd in shd.tree_leaves_with_path(api.param_defs(cfg)):
        block, f = shd.held_block(pd, rules, mesh)
        if f is None:
            kept += 1
            nbytes += np.prod(shd.held_block(pd, plain, mesh)[0]) * 4
        else:
            split += 1
    assert kept and split
    assert got["all-reduce"]["count"] == kept
    assert whole["all-reduce"]["count"] == kept + split
    assert got["all-reduce"]["operand_bytes"] == nbytes * 1.0


def test_fsdp_record_against_the_reference_hlo(mesh_dm):
    """The remaining difference against the reference's count (ROADMAP
    Queue 3): reduced deepseek-7b's FSDP prefill, 8 x 32 tokens on (data 2,
    model 4). The port gathers each of the 21 FSDP-split leaves where it is
    used (263,424 B of blocks a rank) beside its 5 model-axis all-reduces
    and the logits' all-gather; XLA's partitioner, from the same specs,
    emits 12 all-gathers of 215,552 B (it combines gathers and keeps some
    weights' contractions on their shards), 3 all-reduces, an all-to-all
    and 3 collective-permutes. Both counts pinned."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist import sharding as ref_shd
    from repro.launch import hlo_stats as ref_hlo
    from repro.models import api as ref_api

    ref_cfg = ref_configs.reduced(ref_configs.get_config("deepseek-7b"))
    cfg = configs.reduced(configs.get_config("deepseek-7b"))
    rules = ref_shd.rules_for_mesh(mesh_dm, fsdp=True)
    specs = ref_shd.tree_pspecs(ref_api.param_defs(ref_cfg), rules, mesh_dm)
    params = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh_dm, s)),
                          ref_api.init_params(ref_cfg, jax.random.PRNGKey(0)), specs)
    toks = {"tokens": jax.device_put(np.zeros((BATCH, SEQ), np.int32),
                                     NamedSharding(mesh_dm, P("data")))}
    text = jax.jit(ref_api.prefill_fn(ref_cfg, rules, mesh_dm)).lower(
        params, toks).compile().as_text()
    ref = {k: (v["count"], v["operand_bytes"])
           for k, v in ref_hlo.collective_stats(text).items() if v["count"]}
    mesh = MESHES[0]
    port_rules = rules_for_mesh(mesh, fsdp=True)
    fs = lm.tp_stats(lm.fsdp_calls(cfg, "prefill", mesh, port_rules), 2)
    tp = lm.tp_stats(lm.tp_calls(cfg, "prefill", BATCH // 2, SEQ, 4), 4)
    port = {k: (v["count"], v["operand_bytes"])
            for k, v in hlo_stats.total_stats([fs, tp]).items() if v["count"]}
    assert {k: v for k, v in fs.items() if v["count"]} == {
        "all-gather": {"count": 21, "operand_bytes": 263424.0, "wire_bytes": 263424.0}}
    assert port == {"all-reduce": (5, 327680.0), "all-gather": (22, 265472.0)}
    assert ref == {"all-reduce": (3, 196608.0), "all-gather": (12, 215552.0),
                   "all-to-all": (1, 32768.0), "collective-permute": (3, 16896.0)}
