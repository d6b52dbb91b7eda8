"""The port's dry run (``repro_torch.launch.dryrun``), ``summary``,
``reroof`` and ``fill_experiments`` on a small ``SimMesh((2, 2), ("data",
"model"))`` with the reduced configs and 64-token shapes in place of the
published ones: the rows carry the reference's field names, ``long_500k``
skips exactly where the reference's ``shape_supported`` skips, a row's
flops equal the step's count, its gradient-sync
record equals a real simulated-rank train step's Communicator, its
tensor-parallel record a real sharded step's (on (data 2, model 4)), ``reroof``
restores overwritten fields from the saved tables, ``fill_experiments``
run twice gives the same file, and a failing cell fails the CLI."""

import ast
import json
import os

import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import collectives
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.launch import dryrun, fill_experiments, hlo_stats, reroof, summary
from repro_torch.models import api, lm
from repro_torch.train import optim, step as step_mod
from test_torch_hlo_common import BATCH, SEQ, port_flops

MESH = SimMesh((2, 2), ("data", "model"))
ARCHS = ("qwen3-1.7b", "mamba2-130m")
# the port's own fields: where a value was measured, the flops split, the
# collectives' model, flops by op
PORT_FIELDS = {"source", "device", "flops_split", "flops_by_op", "memory_source",
               "collectives_model"}


def _ref_lm_fields():
    """The field names of an analysed ``ok`` LM row of the reference's dry
    run, read from its source: ``_cell_record``'s and the analysis path's
    ``rec.update``'s keywords."""
    path = os.path.join(os.path.dirname(ref_configs.__file__), "..", "launch", "dryrun.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_lm_cell")
    names = set()
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        what = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        keys = {k.arg for k in call.keywords if k.arg}
        if what == "_cell_record" or (what == "update" and "flops_per_device" in keys):
            names |= keys
    return names


@pytest.fixture
def small(monkeypatch):
    """Reduced configs and 64-token shapes under the published names."""
    orig = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda a: configs.reduced(orig(a)))
    for name, s in list(SHAPES.items()):
        monkeypatch.setitem(SHAPES, name, ShapeConfig(name, SEQ, 1 if s.global_batch == 1
                                                      else BATCH, s.kind))
    yield


def _cells(out, **kw):
    return {(a, s): dryrun.run_lm_cell(a, s, False, str(out), mesh=MESH, verbose=False, **kw)
            for a in ARCHS for s in SHAPES}


def test_rows_fields_and_skips(small, tmp_path):
    rows = _cells(tmp_path)
    ref_fields = _ref_lm_fields()
    assert {"flops_per_device", "collectives", "roofline_fraction", "memory"} <= ref_fields
    for (arch, shape), rec in rows.items():
        ok, _ = configs.base.shape_supported(configs.get_config(arch), SHAPES[shape])
        if not ok:
            assert rec["status"] == "skip" and rec["skip_reason"].startswith("long_500k")
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert set(rec) == ref_fields | PORT_FIELDS, set(rec) ^ (ref_fields | PORT_FIELDS)
        assert rec["source"] == "fake" and rec["chips"] == 4
        assert rec["memory"]["peak_bytes_per_device"] > rec["memory"]["argument_size_in_bytes"]
        assert os.path.exists(tmp_path / "single" / "tables" / f"{arch}__{shape}.json")
    assert rows[("qwen3-1.7b", "long_500k")]["status"] == "skip"
    assert rows[("mamba2-130m", "long_500k")]["status"] == "ok"
    # the prefill and decode rows' flops are the step's count (equal to the
    # reference's: test_torch_hlo_flops_serve.py) over the chips; their
    # collectives are the sharded step's model-axis calls (the SSM's too);
    # mamba2's train row adds the optimizer's and the gradient sync's
    size = MESH.shape["model"]
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        for shape, kind in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
            row = rows[(arch, shape)]
            assert row["flops_per_device"] * 4 == port_flops(arch, kind)[0]
            seq = SHAPES[shape].seq_len
            rows_per_rank = SHAPES[shape].global_batch // MESH.shape["data"]
            assert row["collectives"] == lm.tp_stats(
                lm.tp_calls(cfg, kind, rows_per_rank, seq, size), size)
            assert row["t_collective"] > 0.0
    ssm = configs.get_config("mamba2-130m")
    shape = SHAPES["train_4k"]
    model = api.build_model(ssm, torch.device("cpu"),
                            api.tensor_parallel(rules_for_mesh(MESH), MESH, "cpu"))
    calls = (lm.tp_calls(ssm, "train", shape.global_batch // MESH.shape["data"],
                         shape.seq_len, size) + optim.tp_calls(model))
    sync = dryrun.grad_sync_stats(ssm, MESH, rules_for_mesh(MESH), "xla", 2)
    assert rows[("mamba2-130m", "train_4k")]["collectives"] == hlo_stats.total_stats(
        [sync, lm.tp_stats(calls, size)])


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_long_context_skips_as_reference(arch):
    """At the published configs: skip exactly where the reference does, with
    its reason."""
    got = configs.base.shape_supported(configs.get_config(arch), SHAPES["long_500k"])
    want = ref_configs.base.shape_supported(ref_configs.get_config(arch),
                                           ref_configs.base.SHAPES["long_500k"])
    assert got == want


def test_skip_row_written(tmp_path):
    """A skipped cell measures nothing and is written as the reference's."""
    rec = dryrun.run_lm_cell("qwen3-1.7b", "long_500k", True, str(tmp_path), verbose=False)
    assert rec["status"] == "skip" and rec["mesh"] == "multi"
    with open(tmp_path / "multi" / "qwen3-1.7b__long_500k.json") as f:
        assert json.load(f) == rec


@pytest.mark.parametrize("method", ["butterfly", "xla"])
def test_grad_sync_record_equals_a_real_step(small, method):
    """On a data-only mesh (no model axis), the dry run's gradient-sync
    record equals the Communicator's after one real simulated-rank train
    step of the same config; its wire bytes equal the byte model's sum."""
    cfg = configs.get_config("qwen3-1.7b")
    mesh = SimMesh((2,), ("data",))
    rules = rules_for_mesh(mesh)
    got = dryrun.grad_sync_stats(cfg, mesh, rules, method, 2)
    comm = collectives.Communicator(mesh, "cpu")
    model = api.init_params(cfg, 0, device="cpu")
    fn = step_mod.build_train_step_butterfly(
        cfg, mesh, rules, method="xla_psum" if method == "xla" else method, comm=comm)
    batch = {k: torch.zeros((BATCH, SEQ), dtype=torch.int32) for k in ("tokens", "labels")}
    fn(model, optim.get(cfg.optimizer).init(model), batch, 0)
    assert got == hlo_stats.collective_stats(comm)
    assert sum(v["wire_bytes"] for v in got.values()) == comm.bytes_sent[0]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b"])
def test_tp_record_equals_a_real_sharded_step(arch, kind):
    """On (data 2, model 4): the dry run's model-axis record of a step,
    taken under fake tensors, equals a real reduced sharded step's
    ``TensorParallel`` record (and the byte model)."""
    cfg = configs.reduced(configs.get_config(arch))
    mesh = SimMesh((2, 4), ("data", "model"))
    rules = rules_for_mesh(mesh)
    shape = ShapeConfig("cell", SEQ, BATCH, kind)
    got = dryrun.tp_step_stats(cfg, shape, mesh, rules)
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    toks = torch.zeros((BATCH, SEQ), dtype=torch.int32)
    with torch.no_grad():
        if kind == "prefill":
            api.prefill_fn(cfg, rules, mesh)(model, {"tokens": toks})
        elif kind == "decode":
            cache = shd.tree_map(lambda pd: torch.zeros(pd.shape),
                                 api.cache_defs(cfg, shape))
            api.decode_fn(cfg, rules, mesh)(model, cache, toks[:, :1], SEQ - 1)
    extra = []
    if kind == "train":
        fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules)
        fn(model, optim.get(cfg.optimizer).init(model), {"tokens": toks, "labels": toks}, 0)
        extra = optim.tp_calls(model)
    assert got == hlo_stats.total_stats([model.tp.stats])
    assert got == lm.tp_stats(lm.tp_calls(cfg, kind, BATCH // 2, SEQ, 4) + extra, 4)
    assert got["all-reduce"]["count"] > 0
    # a mesh without a model axis: no tensor-parallel term; the SSM family's
    # is its byte model's (test_ssm_tp_record_equals_a_real_sharded_step)
    assert dryrun.tp_step_stats(cfg, shape, SimMesh(2), rules_for_mesh(SimMesh(2))) is None
    ssm = configs.reduced(configs.get_config("mamba2-130m"))
    assert dryrun.tp_step_stats(ssm, shape, mesh, rules) == lm.tp_stats(
        lm.tp_calls(ssm, kind, BATCH // 2, SEQ, 4) + (optim.tp_calls(api.build_model(
            ssm, torch.device("cpu"), api.tensor_parallel(rules, mesh, "cpu")))
            if kind == "train" else []), 4)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,changes", [("mamba2-130m", {}),
                                          ("mamba2-130m", {"ssm_head_dim": 128}),
                                          ("jamba-v0.1-52b", {}), ("internvl2-26b", {}),
                                          ("whisper-medium", {})])
def test_family_tp_record_equals_a_real_sharded_step(arch, changes, kind):
    """The SSM, hybrid, VLM and encoder-decoder families on (data 2, model
    4), the SSM's heads also straddling the ranks: the dry run's record
    equals a real reduced sharded step's (decode against the held cache)
    and the byte model."""
    import dataclasses

    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), **changes)
    mesh = SimMesh((2, 4), ("data", "model"))
    rules = rules_for_mesh(mesh)
    shape = ShapeConfig("cell", SEQ, BATCH, kind)
    got = dryrun.tp_step_stats(cfg, shape, mesh, rules)
    model = api.init_params(cfg, 0, device="cpu", rules=rules, mesh=mesh)
    ins = shd.tree_map(lambda pd: torch.zeros(pd.shape, dtype=shd.resolve_dtype(pd, "float32")),
                       api.input_defs(cfg, shape))
    with torch.no_grad():
        if kind == "prefill":
            api.prefill_fn(cfg, rules, mesh)(model, ins)
        elif kind == "decode":
            cache = api.held_cache(model, shd.tree_map(lambda pd: torch.zeros(pd.shape),
                                                       api.cache_defs(cfg, shape)))
            api.decode_fn(cfg, rules, mesh)(model, cache, ins["token"], SEQ - 1)
    extra = []
    if kind == "train":
        fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules)
        fn(model, optim.get(cfg.optimizer).init(model), ins, 0)
        extra = optim.tp_calls(model)
    text = SEQ - (cfg.n_patches if cfg.family == "vlm" else 0)
    assert got == hlo_stats.total_stats([model.tp.stats])
    assert got == lm.tp_stats(lm.tp_calls(cfg, kind, BATCH // 2, text, 4) + extra, 4)
    assert got["all-reduce"]["count"] > 0


def test_straddling_production_row_equals_the_byte_model():
    """mamba2-130m's prefill and long-context decode rows at its published
    size on the production mesh's model 16 (24 heads: 1.5 a rank, so the
    scan runs replicated behind an all-gather), under fake tensors: their
    model-axis terms equal the byte model's."""
    from repro_torch.launch import mesh as launch_mesh

    cfg = configs.get_config("mamba2-130m")
    mesh = launch_mesh.make_production_mesh(multi_pod=False)
    rules = rules_for_mesh(mesh)
    size = mesh.shape["model"]
    assert size == 16 and cfg.n_ssm_heads % size and cfg.d_inner % size == 0
    shape = SHAPES["prefill_32k"]
    got = dryrun.tp_step_stats(cfg, shape, mesh, rules)
    rows_per_rank = shape.global_batch // (mesh.ranks // size)
    calls = lm.tp_calls(cfg, "prefill", rows_per_rank, shape.seq_len, size)
    assert ("all-gather", rows_per_rank * shape.seq_len * cfg.d_inner // size * 2) in calls
    assert got == lm.tp_stats(calls, size)
    # long_500k decodes one row: fewer rows than the 16 data groups, so the
    # batch is replicated over them (the reference's spec fallback) and
    # every group's calls carry the whole row
    long = SHAPES["long_500k"]
    assert long.global_batch == 1
    got = dryrun.tp_step_stats(cfg, long, mesh, rules)
    assert got == lm.tp_stats(lm.tp_calls(cfg, "decode", 1, long.seq_len, size), size)


def test_tp_record_against_the_reference_hlo(mesh_dm):
    """The remaining difference against the reference's count (ROADMAP
    Queue 3): reduced qwen3-1.7b's prefill, 4 x 32 tokens on (data 2,
    model 4). XLA's partitioner, from the same specs, emits 3 all-reduces
    of 32,768 B; the port's Megatron-style pass makes 5 (the vocab-parallel
    embedding's and each layer's two) and all-gathers the last position's
    logits. The activations' all-reduce operand is the same 32,768 B."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist import sharding as ref_shd
    from repro.launch import hlo_stats as ref_hlo
    from repro.models import api as ref_api

    ref_cfg = ref_configs.reduced(ref_configs.get_config("qwen3-1.7b"))
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    rules = ref_shd.rules_for_mesh(mesh_dm)
    specs = ref_shd.tree_pspecs(ref_api.param_defs(ref_cfg), rules, mesh_dm)
    params = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh_dm, s)),
                          ref_api.init_params(ref_cfg, jax.random.PRNGKey(0)), specs)
    toks = {"tokens": jax.device_put(np.zeros((4, 32), np.int32),
                                     NamedSharding(mesh_dm, P("data")))}
    text = jax.jit(ref_api.prefill_fn(ref_cfg, rules, mesh_dm)).lower(
        params, toks).compile().as_text()
    ref = {k: (v["count"], v["operand_bytes"])
           for k, v in ref_hlo.collective_stats(text).items() if v["count"]}
    port = {k: (v["count"], v["operand_bytes"])
            for k, v in lm.tp_stats(lm.tp_calls(cfg, "prefill", 2, 32, 4), 4).items()
            if v["count"]}
    assert ref == {"all-reduce": (3, 98304.0)}
    assert port == {"all-reduce": (5, 163840.0), "all-gather": (1, 1024.0)}


def test_reroof_summary_fill(small, tmp_path, capsys):
    out = str(tmp_path / "dr")
    rec = dryrun.run_lm_cell("qwen3-1.7b", "train_4k", False, out, mesh=MESH,
                             grad_sync="butterfly", verbose=False)
    dryrun.run_lm_cell("qwen3-1.7b", "long_500k", False, out, mesh=MESH, verbose=False)
    dryrun.run_bfs_cell(False, out, scale=10, edge_factor=8, fanout=2, mesh=MESH,
                        verbose=False)
    assert rec["collectives"]["collective-permute"]["count"] > 0
    jp = os.path.join(out, "single", "qwen3-1.7b__train_4k.json")
    with open(jp) as f:
        want = json.load(f)
    clobbered = dict(want, t_compute=-1.0, dominant="?", flops_per_device=0.0,
                     collectives={}, roofline_fraction=-1.0, memory={})
    with open(jp, "w") as f:
        json.dump(clobbered, f)
    assert reroof.main(["--dir", out]) == 0
    with open(jp) as f:
        assert json.load(f) == want
    # summary: the tables, with the H100's memory
    assert summary.main(["--dir", out]) == 0
    text = capsys.readouterr().out
    assert "fits H100" in text and "| qwen3-1.7b" in text and "permutes/level" in text
    # fill_experiments: the markers replaced, idempotent
    md = tmp_path / "notes.md"
    md.write_text("# notes\n\n<!-- DRYRUN_TABLES -->\n\ntext\n\n<!-- ROOFLINE_TABLES -->\n")
    assert fill_experiments.main(["--dir", out, "--file", str(md)]) == 0
    once = md.read_text()
    assert "BEGIN DRYRUN" in once and "BEGIN ROOFLINE" in once and "fits H100" in once
    assert fill_experiments.main(["--dir", out, "--file", str(md)]) == 0
    assert md.read_text() == once


def test_cli_exit_codes(small, tmp_path, monkeypatch):
    out = str(tmp_path / "cli")
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k,long_500k",
                        "--mesh", "single", "--out", out, "--override",
                        "ring_local_cache=True"]) == 0
    with open(os.path.join(out, "single", "qwen3-1.7b__decode_32k.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["overrides"] == {"ring_local_cache": True}
    assert dryrun._parse_overrides("a=True,b=8,c='x'") == {"a": True, "b": 8, "c": "x"}
    # --no-analysis: memory only
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "prefill_32k", "--mesh",
                        "multi", "--out", out, "--no-analysis"]) == 0
    with open(os.path.join(out, "multi", "qwen3-1.7b__prefill_32k.json")) as f:
        rec = json.load(f)
    assert rec["analysis"] is False and rec["chips"] == 512 and "flops_per_device" not in rec

    def broken(*a, **k):
        raise RuntimeError("broken step")

    monkeypatch.setattr(dryrun, "fake_step", broken)
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k", "--mesh", "single",
                        "--out", out]) == 1
    with open(os.path.join(out, "single", "mamba2-130m__train_4k.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "fail" and "broken step" in rec["error"] and rec["trace"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b", "whisper-medium"])
def test_input_specs_match_reference(mesh_dm, arch, shape):
    """``input_specs`` at a published config on (data 2, model 4): every
    input's and cache entry's shard shape and dtype equal the reference's
    sharded ``ShapeDtypeStruct`` on ``mesh_dm``."""
    import jax

    from repro.dist import sharding as ref_shd
    from repro.models import api as ref_api
    from repro_torch.dist import sharding as shd

    rcfg, rshape = ref_configs.get_config(arch), ref_configs.base.SHAPES[shape]
    rules = ref_shd.rules_for_mesh(mesh_dm, rcfg.fsdp)
    want = {"inputs": ref_shd.tree_structs(ref_api.input_defs(rcfg, rshape),
                                           rcfg.compute_dtype, rules, mesh_dm)}
    if rshape.kind == "decode":
        want["cache"] = ref_shd.tree_structs(ref_api.cache_defs(rcfg, rshape),
                                             rcfg.compute_dtype, rules, mesh_dm)
    mesh = SimMesh((2, 4), ("data", "model"))
    got = dryrun.input_specs(arch, shape, mesh,
                             rules_for_mesh(mesh, configs.get_config(arch).fsdp))
    flat = {path: s for path, s in shd.tree_leaves_with_path(got)}
    ref_flat = {tuple(k.key for k in path): s for path, s in
                jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat) == set(ref_flat)
    for path, s in flat.items():
        r = ref_flat[path]
        assert s.shape == tuple(r.shape) and s.dtype.itemsize == r.dtype.itemsize
        assert s.shard_shape == tuple(r.sharding.shard_shape(r.shape)), path
