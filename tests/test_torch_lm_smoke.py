"""chip_smoke.py's LM phase (phase 3) on the CPU: its helpers (the decode
step's HBM bound, the chunk plans it names, the tolerance check) and the
phase itself rehearsed at the reduced configs, with the CUDA calls stubbed.
"""

import dataclasses
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import api, layers, mamba2  # noqa: E402


def test_kv_bytes_per_token_of_the_served_model():
    """qwen3-1.7b: 28 layers x K and V x 8 heads x 128 x 2 bytes."""
    cfg = configs.get_config("qwen3-1.7b")
    assert chip_smoke.kv_bytes_per_token(cfg) == 114_688
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    assert chip_smoke.kv_bytes_per_token(f32) == 2 * 114_688
    jamba = configs.get_config("jamba-v0.1-52b")  # 1 attention layer in 8
    assert chip_smoke.kv_bytes_per_token(jamba) == 4 * 2 * 8 * 128 * 2


def test_the_consistency_checks_cover_both_chunk_plans():
    (qa, _, qp, qs), (ma, _, mp, ms) = chip_smoke.LM_CHECKS
    q = configs.get_config(qa)
    assert [layers.attn_chunking(q, n)[:2] for n in (qp, qp + qs)] == [(1024, 3), (64, 49)]
    m = configs.get_config(ma)
    assert [mamba2.ssd_chunk(m.ssm_chunk, n) for n in (mp, mp + ms)] == [256, 32]


def test_check_close_passes_inside_and_raises_outside():
    want = torch.tensor([[1.0, -2.0, 0.0]])
    out = chip_smoke.check_close("x", want + 1e-3, want, 2e-2, 2e-3)
    assert out["max_abs_err"] == pytest.approx(1e-3, rel=1e-3) and out["tol_share"] < 1
    with pytest.raises(AssertionError, match="outside"):
        chip_smoke.check_close("x", want + torch.tensor([[0.0, 0.1, 0.0]]), want, 2e-2, 2e-3)
    with pytest.raises(AssertionError, match="outside"):
        chip_smoke.check_close("x", want * float("nan"), want, 2e-2, 2e-3)


class _Event:
    """A host-clock stand-in for ``torch.cuda.Event``."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture()
def cpu_lm(monkeypatch):
    """The CUDA calls of phase 3 made no-ops, its events host clocks, and its
    models the reduced configs at its shapes cut down."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name: configs.reduced(full(name)))
    monkeypatch.setattr(chip_smoke, "LM_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "LM_PROMPT", 12)
    monkeypatch.setattr(chip_smoke, "LM_NEW", 5)
    monkeypatch.setattr(chip_smoke, "LM_TOP_K", 8)
    monkeypatch.setattr(chip_smoke, "LM_CHECKS", (("qwen3-1.7b", 2, 24, 4),
                                                  ("mamba2-130m", 2, 16, 3)))
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


def test_lm_phase_rehearsed_on_the_cpu(cpu_lm):
    out = chip_smoke.run_lm(cpu_lm, 0, profile_decode=True)
    serve = out["serve"]
    assert serve["params"] == api.param_counts(configs.get_config("qwen3-1.7b"))["total"]
    assert len(serve["generate_s"]) == 2 and serve["decode_bound_ms_median"] > 0
    assert [c["rows"] for c in out["consistency"]] == [5, 4]
    assert set(out["reduced"]) == set(configs.ARCH_NAMES)
    assert all(r["greedy_agreement"] == 1.0 for r in out["reduced"].values())
    assert out["decode_profile"]["launches"] == 0  # no graph kernel on this path


def test_lm_phase_refuses_a_decode_that_drifts(cpu_lm, monkeypatch):
    """A cache that loses what prefill wrote fails the consistency check."""
    from repro_torch.serve import engine

    real = engine.prepare_decode_cache

    def forgetful(cfg, cache, pos, max_len):
        out = real(cfg, cache, pos, max_len)
        for leaf in (out["blocks"]["k"], out["blocks"]["v"]):
            leaf[:, :, :pos // 2] = 0
        return out

    monkeypatch.setattr(engine, "prepare_decode_cache", forgetful)
    with pytest.raises(AssertionError, match="prefill \\+ decode against the forward"):
        chip_smoke.lm_consistency("qwen3-1.7b", 2, 24, 4, cpu_lm, 0)
