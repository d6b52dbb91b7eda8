"""``chip_smoke.py --coverage lm`` and ``--coverage graph`` rehearsed on the
CPU: each group's function at toy sizes (the reduced configs, a scale-10
Kronecker graph on pod 2 x data 4), the CUDA calls made no-ops and the
kernel wrappers counted, so that a mistake in a group shows here before a
chip run. A group whose check is broken (one bit of a mesh run's
distances flipped, one logit of an FSDP run moved) raises."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.kernels import build
from test_torch_lm_smoke import _Event
from test_torch_smoke_bounds import cpu_card  # noqa: F401
from test_torch_tp_common import one_torch_thread  # noqa: F401

LM_SMALL = {
    "FSDP_SERVE": (4, 12, 4), "FSDP_TRAIN_LAYERS": 4, "FSDP_TRAIN_BATCH": 8,
    "FSDP_TRAIN_SEQ": 32, "FSDP_STEP": (4, 32, 2),
    "TRAIN_LR": {"peak": 1e-2, "warmup": 1, "total": 3},
    "COV_MOE_LAYERS": 2, "COV_MOE_TRAIN_LAYERS": 1, "COV_MOE_SERVE": (4, 12, 4), "COV_MOE_TRAIN": (2, 4, 16, 2),
    "COV_GEMMA_LAYERS": 6, "COV_GEMMA_TRAIN_LAYERS": 2, "COV_GEMMA_SERVE": (2, 24, 4),
    "COV_GEMMA_TRAIN": (2, 2, 24, 1),
    "COV_KIMI_LAYERS": 2, "COV_KIMI_EXPERTS": 4, "COV_KIMI_SERVE": (4, 12, 4),
    "COV_FSDP_SERVE": {"jamba-v0.1-52b": (4, 16, 3), "internvl2-26b": (4, 12, 3),
                       "whisper-medium": (4, 12, 3)},
    "COV_FSDP_STEP": {"internvl2-26b": (4, 16, 2), "whisper-medium": (4, 16, 2)},
    "COV_STATE_SHAPE": (4, 16, 2),
    "COV_FAMILY_STEP": {a: (4, 16, 2) for a in chip_smoke.COV_FAMILIES},
    "COV_GLOO_SERVE": (4, 12, 3), "COV_GLOO_STEP": (4, 16),
    "COV_SERVE_LM_NEW": 3, "COV_SYNC_LEAVES": ((16, 8), (5,)), "COV_PREFILL": (2, 16),
    "TPF_SERVE": {"mamba2-130m": (None, 4, 16, 3), "whisper-medium": (None, 4, 12, 3),
                  "internvl2-26b": (2, 4, 12, 3), "jamba-v0.1-52b": (8, 4, 16, 3)},
    "TPF_CHECK": {a: (2, 16, 3) for a in chip_smoke.TPF_CHECK},
    "TPF_STEP": {a: (4, 16, 2) for a in chip_smoke.TPF_STEP},
    "GPIPE_STAGES": 2, "GPIPE_ROWS": 8, "GPIPE_REPS": 1,
}


@pytest.fixture
def cpu_cov(monkeypatch):
    """The LM coverage on the CPU: the reduced configs (the FSDP arch in
    bfloat16 with remat, as 3g's rehearsal), toy shapes, no-op CUDA calls,
    and GPipe at the reduced qwen3's width."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    full = configs.get_config

    def small(name):
        cfg = configs.reduced(full(name))
        if name == chip_smoke.FSDP_ARCH:
            cfg = dataclasses.replace(cfg, remat=True, param_dtype="bfloat16",
                                      compute_dtype="bfloat16", train_microbatches=2)
        if name == "whisper-medium":  # split kv heads on model 4, as the published 16
            cfg = dataclasses.replace(cfg, n_kv_heads=4)
        return cfg

    monkeypatch.setattr(configs, "get_config", small)
    for name, value in LM_SMALL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


def test_lm_coverage_rehearsed_on_the_cpu(cpu_cov, tmp_path):
    out = chip_smoke.run_lm_coverage(cpu_cov, 0, str(tmp_path))
    assert list(out)[::2] == list(chip_smoke.LM_GROUPS)
    loss = out["loss"]
    assert loss["plain_loss_rel_err"] <= chip_smoke.FSDP_LOSS_TOL
    fsdp = out["fsdp"]
    for key in ("qwen3-moe serve", "gemma3 serve", "gemma3 serve ring", "kimi-k2 serve",
                "jamba-v0.1-52b serve", "internvl2-26b serve", "whisper-medium serve"):
        assert fsdp[key]["fsdp_calls"] > 0 and fsdp[key]["first_tokens_equal"] == 1.0, key
    assert fsdp["kimi-k2 serve"]["apart"] and fsdp["qwen3-moe train"]["optimizer"] == "adafactor"
    assert fsdp["internvl2-26b step"]["worst_rel_err"] <= chip_smoke.TP_REL_TOL
    state = out["state"]
    assert state["restart"]["fsdp"] and state["pod_step"]["mesh"] == chip_smoke.COV_POD_MESH
    assert state["restore"]["data 8, fsdp"]["split_leaves"] > 0
    fam = out["families"]
    for arch in chip_smoke.COV_FAMILIES:
        assert fam[f"{arch} butterfly"]["sync_bytes_per_rank"] > 0
        apart = arch in chip_smoke.COV_UNSHARDED_TRAIN
        run = fam[f"{arch} {'train' if apart else 'restart'}"]
        assert len(run["losses"]) == chip_smoke.COV_FAMILY_PLAN[0]
        assert (run["mesh"] is None) == apart
    assert fam["gloo"]["checks"]["grads_rel_err"] <= chip_smoke.TP_REL_TOL
    other = out["other"]
    assert set(other["serve_lm"]) == set(configs.ARCH_NAMES)
    assert other["gpipe"]["data"] == 2 and other["prefill_flops"]["flops"] > 0
    assert all(r["rel_err"] <= chip_smoke.SYNC_REL_TOL for k, r in other["syncs"].items()
               if not k.startswith("int8"))


def test_multi_card_families_rehearsed_over_gloo(cpu_cov, monkeypatch):
    """``--coverage lm --multi-card``'s group 5 (a family's serving, one
    model rank a process on data 1 x model 4) over gloo on the CPU, for
    mamba2: each process's logits, tokens and record against the
    simulated ranks."""
    monkeypatch.setattr(chip_smoke, "COV_FAMILIES", ("mamba2-130m",))
    out = chip_smoke.tpf_multi_card(cpu_cov, 0, 4, backend="gloo")
    checks = out["mamba2-130m"]["checks"]
    assert out["mamba2-130m"]["mesh"] == ((1, 4), ("data", "model"))
    assert all(checks[f"rank{r}_tokens_equal"] == 1.0 for r in range(4))
    assert all(checks[f"rank{r}_logits_rel_err"] <= chip_smoke.TP_REL_TOL for r in range(4))


def test_lm_coverage_refuses_a_moved_logit(cpu_cov, monkeypatch):
    """One logit of the FSDP run's prefill moved past 3f's bound: the
    FSDP group raises."""
    from repro_torch.models import api

    real = api.prefill_fn

    def moved(cfg, rules=None, mesh=None):
        fn = real(cfg, rules, mesh)
        if rules is None or not rules.fsdp:
            return fn

        def call(model, ins):
            logits, *rest = fn(model, ins)
            logits = logits.clone()
            logits[0, 0] += 1.0
            return (logits, *rest)
        return call

    monkeypatch.setattr(api, "prefill_fn", moved)
    with pytest.raises(AssertionError, match="FSDP serving"):
        chip_smoke.fsdp_serve(cpu_cov, 0)


@pytest.fixture(scope="module")
def kron10():
    import unittest.mock as mock

    from repro_torch.graph import generators

    with mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        return chip_smoke.etl("kronecker 10", lambda: generators.kronecker(
            10, 8, seed=0, max_weight=chip_smoke.WEIGHT), 8, torch.device("cpu"),
            "direction_optimizing")


class _Args:
    scale, edge_factor, ranks, fanout, seed = 10, 8, 8, 4, 0
    kcore_scale, tri_scale, cli_scale, cli_seconds = 9, 9, 9, 3.0


def test_graph_coverage_rehearsed_on_the_cpu(cpu_card, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "merge_profile", lambda label, run: {})
    args = _Args()
    args.cli_out = str(tmp_path)
    out, sites = chip_smoke.run_graph_coverage(args, cpu_card, chip_smoke.log, str(tmp_path))
    paths = out["paths"]
    for label in ("axes wave butterfly", "axes wave adaptive", "axes bc butterfly",
                  "axes pagerank butterfly", "axes kcore butterfly", "axes tri adaptive",
                  "axes engine"):
        assert label in paths, label
    assert paths["axes wave butterfly"]["launches"]["bitmap_or_reduce"] > 0
    assert any(k.startswith("axes repair bfs") for k in paths)
    assert sites and all(r["max_abs_err"] == 0 and r["launches"] > 0 for r in sites)
    assert {r["path"] for r in sites} >= {"axes wave butterfly", "axes bc butterfly"}
    assert len(out["straddle"]) == 12
    serving = out["serving"]
    assert serving["a"]["trace_events"] > 0 and serving["replay"].startswith("replayed")
    assert serving["b"]["faults"]["hedges"] >= 1
    assert serving["bc"]["max_abs_diff"] <= 1e-4


def test_graph_coverage_refuses_a_flipped_distance(cpu_card, kron10, monkeypatch):
    """One bit of the mesh wave's distances flipped: the traversal group
    raises."""
    from repro_torch.analytics import msbfs

    real = msbfs.build_msbfs_fn

    def flipped(pg, cfg, n_lanes, **kw):
        fn = real(pg, cfg, n_lanes, **kw)
        if kw.get("mesh") is None:
            return fn

        def call(*a, **k):
            d, *rest = fn(*a, **k)
            d = d.clone()
            d.view(-1)[0] ^= 1
            return (d, *rest)
        return call

    monkeypatch.setattr(msbfs, "build_msbfs_fn", flipped)
    kron10["scale"] = 10
    with chip_smoke.KernelCensus() as census, \
            pytest.raises(AssertionError, match="axes wave butterfly"):
        chip_smoke.cov_traversals(kron10, {}, 4, 0, torch.device("cpu"), census)
