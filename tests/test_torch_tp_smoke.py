"""Phases 3e and 3f of ``chip_smoke.py`` rehearsed on the CPU: the
tensor-parallel serving, the float32 step check, the sharded training
loop and the butterfly step in 4 gloo processes, at the reduced qwen3-1.7b
(bfloat16, remat, 2 microbatches); 3f's serving, float32 checks and steps
at the reduced mamba2, whisper, internvl2 and jamba; shapes cut down, the
CUDA calls made no-ops; none of the four graph kernels launched. A
sharded pass whose byte model disagrees with its record fails the
phase, and so does sharded serving whose answers are wrong."""

import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.core import collectives
from repro_torch.kernels import build
from repro_torch.models import lm
from test_torch_lm_smoke import _Event
from test_torch_tp_common import one_torch_thread  # noqa: F401


@pytest.fixture
def cpu_tp(monkeypatch):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    full = configs.get_config

    def small(name):
        cfg = configs.reduced(full(name))
        if name == chip_smoke.LM_ARCH:
            cfg = dataclasses.replace(cfg, remat=True, param_dtype="bfloat16",
                                      compute_dtype="bfloat16", train_microbatches=2)
        return cfg

    monkeypatch.setattr(configs, "get_config", small)
    for name, value in (("LM_BATCH", 4), ("TP_PROMPT", 12), ("TP_NEW", 4),
                        ("TP_CHECK", (2, 16, 3)), ("TRAIN_BATCH", 8), ("TRAIN_SEQ", 32),
                        ("TRAIN_STEPS", 3), ("TP_TRAIN_STEPS", 3),
                        ("TRAIN_LR", {"peak": 1e-2, "warmup": 1, "total": 3}),
                        ("TP_GLOO_BATCH", 4), ("TP_GLOO_SEQ", 16),
                        ("FSDP_GLOO_BATCH", 4), ("FSDP_GLOO_SEQ", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


def test_tp_phase_rehearsed_on_the_cpu(cpu_tp):
    out = chip_smoke.run_tp(cpu_tp, 0)
    serve = out["serve"]
    assert serve["n_calls"] > 0 and serve["bytes_per_rank"] > 0
    assert 0.0 <= serve["tokens_equal_share"] <= 1.0
    assert serve["float32"]["tol_share"] <= 1.0
    step = out["step"]
    assert step["worst_rel_err"] <= chip_smoke.TP_REL_TOL
    assert step["step_bytes_per_rank"] > step["grad_bytes_per_rank"] > 0
    train = out["train"]
    assert len(train["losses"]) == 3 and train["losses"][-1] < train["losses"][0]
    gloo = out["gloo"]
    assert gloo["checks"]["grads_rel_err"] <= chip_smoke.TP_REL_TOL
    assert gloo["checks"]["params_max_abs_err"] <= gloo["checks"]["update_bound"]
    assert all(gloo["checks"][f"rank{r}_loss_rel_err"] <= chip_smoke.TP_REL_TOL
               for r in range(chip_smoke.TP_GLOO_WORLD))


def test_multi_card_tp_rehearsed_over_gloo(cpu_tp):
    """``--multi-card``'s phase 3e (serving and a GSPMD step, one model rank
    a process on data 1 x model 4) over gloo on the CPU: every process's
    logits, tokens, loss, gradient and record equal to the simulated
    ranks'."""
    out = chip_smoke.tp_multi_card(cpu_tp, 0, 4, backend="gloo")
    checks = out["checks"]
    assert out["mesh"] == ((1, 4), ("data", "model"))
    for r in range(4):
        assert checks[f"rank{r}_logits_rel_err"] <= chip_smoke.TP_REL_TOL
        assert checks[f"rank{r}_tokens_equal"] == 1.0
        assert checks[f"rank{r}_loss_rel_err"] <= chip_smoke.TP_REL_TOL
    assert checks["grads_rel_err"] <= chip_smoke.TP_REL_TOL


def test_tp_phase_refuses_a_wrong_byte_model(cpu_tp, monkeypatch):
    real = lm.tp_calls
    monkeypatch.setattr(lm, "tp_calls", lambda *a, **k: real(*a, **k)[1:])
    with pytest.raises(AssertionError, match="model-axis calls"):
        chip_smoke.tp_step_check(cpu_tp, 0)


def test_gloo_phases_run_beside_and_log_when_joined(cpu_tp, capsys):
    """Phases 3c(d) and 3e(d) as the default run starts them: in a thread
    beside the host work that follows (their processes spawned from it),
    their log lines held until the join, both results returned, and a
    second join the same."""
    beside = chip_smoke.Beside(chip_smoke.gloo_phases, cpu_tp, 0)
    chip_smoke.log("host work")
    out = beside.join()
    printed = capsys.readouterr().out
    assert printed.index("host work") < printed.index("[3c/27 (d) and 3e/27 (d)]")
    assert set(out["dist"]["methods"]) == {f"{m} fanout {f}" for m, f in chip_smoke.DIST_CASES}
    assert all(rec["bit_equal"] or rec["rel_err"] <= chip_smoke.SYNC_REL_TOL
               for rec in out["dist"]["methods"].values())
    assert out["gloo"]["checks"]["grads_rel_err"] <= chip_smoke.TP_REL_TOL
    assert beside.join() is out


@pytest.fixture
def cpu_tpf(cpu_tp, monkeypatch):
    """Phase 3f's shapes cut down for the CPU (the reduced configs)."""
    monkeypatch.setattr(chip_smoke, "TPF_SERVE", {
        "mamba2-130m": (None, 4, 16, 3), "whisper-medium": (None, 4, 12, 3),
        "internvl2-26b": (2, 4, 12, 3), "jamba-v0.1-52b": (8, 4, 16, 3)})
    monkeypatch.setattr(chip_smoke, "TPF_CHECK", {a: (2, 16, 3) for a in chip_smoke.TPF_CHECK})
    monkeypatch.setattr(chip_smoke, "TPF_STEP", {a: (4, 16, 2) for a in chip_smoke.TPF_STEP})
    yield cpu_tp


def test_tp_families_phase_rehearsed_on_the_cpu(cpu_tpf):
    """Phase 3f at the four reduced configs: serving against the unsharded
    run (jamba's built apart), the float32 checks (mamba2's 8 heads also
    on model 16, straddling), the float32 steps; no graph kernel."""
    out = chip_smoke.run_tp_families(cpu_tpf, 0)
    assert list(out) == ["mamba2-130m", "whisper-medium", "internvl2-26b", "jamba-v0.1-52b"]
    for arch, rec in out.items():
        serve = rec["serve"]
        assert serve["n_calls"] > 0 and serve["bytes_per_rank"] > 0
        assert 0.0 <= serve["tokens_equal_share"] <= 1.0
        assert serve["apart"] == (arch == "jamba-v0.1-52b")
        if arch == "jamba-v0.1-52b":
            assert "float32" not in rec
            continue
        f32 = rec["float32"]
        assert f32["serve"]["tol_share"] <= 1.0
        assert f32["step"]["worst_rel_err"] <= chip_smoke.TP_REL_TOL
        assert f32["step"]["step_bytes_per_rank"] > f32["step"]["grad_bytes_per_rank"] > 0
    assert out["mamba2-130m"]["float32"]["straddle"]["heads_a_rank"] == 0.5


def test_tp_families_phase_split_by_flag(cpu_tpf):
    """``--lm-only`` runs 3f's serving and float32 checks, ``--train-only``
    its steps alone."""
    serve = chip_smoke.run_tp_families(cpu_tpf, 0, serve=True, train=False)
    assert all("step" not in r.get("float32", {}) for r in serve.values())
    train = chip_smoke.run_tp_families(cpu_tpf, 0, serve=False, train=True)
    assert all("serve" not in r for r in train.values())
    assert all("step" in r["float32"] and "serve" not in r["float32"]
               for a, r in train.items() if a in chip_smoke.TPF_CHECK)


def test_tp_families_phase_refuses_a_wrong_byte_model(cpu_tpf, monkeypatch):
    real = lm.tp_calls
    monkeypatch.setattr(lm, "tp_calls", lambda *a, **k: real(*a, **k)[1:])
    with pytest.raises(AssertionError, match="model-axis calls"):
        chip_smoke.tpf_serve("mamba2-130m", cpu_tpf, 0)


def test_tp_families_phase_refuses_wrong_sharded_serving(cpu_tpf, monkeypatch):
    """jamba's sharded serving with every row-parallel sum off by half: its
    record still equals the byte model, its prefill logits leave
    TPF_LOGIT_TOL of the unsharded run's and the phase fails."""
    real = collectives.TensorParallel.reduce
    monkeypatch.setattr(collectives.TensorParallel, "reduce", lambda self, t: real(self, t) * 1.5)
    with pytest.raises(AssertionError, match="prefill logits"):
        chip_smoke.tpf_serve("jamba-v0.1-52b", cpu_tpf, 0)
