"""Phase 3g of ``chip_smoke.py`` rehearsed on the CPU: FSDP beside tensor
parallelism at the reduced deepseek-7b (bfloat16, remat, 2 microbatches;
its FSDP rules forced by the phase): serving bit-equal to the
tensor-parallel run, the float32 step against the tensor-parallel step,
training through ``train.loop.train`` and the FSDP GSPMD step in 4 gloo
processes against the simulated ranks; shapes cut down, the CUDA calls
made no-ops; none of the four graph kernels launched. A pass whose byte
model disagrees with its record fails the phase."""

import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.kernels import build
from test_torch_lm_smoke import _Event
from test_torch_tp_common import one_torch_thread  # noqa: F401


@pytest.fixture
def cpu_fsdp(monkeypatch):
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
        return cfg

    monkeypatch.setattr(configs, "get_config", small)
    for name, value in (("FSDP_SERVE", (4, 12, 4)), ("FSDP_TRAIN_LAYERS", 4),
                        ("FSDP_TRAIN_BATCH", 8), ("FSDP_TRAIN_SEQ", 32),
                        ("FSDP_STEP", (4, 32, 2)), ("FSDP_GLOO_BATCH", 4),
                        ("FSDP_GLOO_SEQ", 16),
                        ("TRAIN_LR", {"peak": 1e-2, "warmup": 1, "total": 3})):
        monkeypatch.setattr(chip_smoke, name, value)
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


def test_fsdp_phase_rehearsed_on_the_cpu(cpu_fsdp):
    out = chip_smoke.run_fsdp(cpu_fsdp, 0)
    serve = out["serve"]
    assert serve["bit_equal"] and serve["tokens_equal_share"] == 1.0
    assert serve["fsdp_calls"] > 0 and serve["fsdp_bytes_per_rank"] > 0
    assert serve["tp_calls"] > 0 and serve["tp_bytes_per_rank"] > 0
    step = out["step"]
    assert step["worst_rel_err"] <= chip_smoke.TP_REL_TOL
    assert step["params_worst_rel_err"] <= chip_smoke.TP_REL_TOL
    assert step["step_fsdp_bytes_per_rank"] > step["grad_fsdp_bytes_per_rank"] > 0
    train = out["train"]
    assert len(train["losses"]) == 3 and train["losses"][-1] < train["losses"][0]
    gloo = out["gloo"]
    assert gloo["checks"]["grads_rel_err"] <= chip_smoke.TP_REL_TOL
    assert all(d["step_peak_bytes"] == 0 for d in gloo["dist"])  # the CPU reads none
    assert all(gloo["checks"][f"rank{r}_loss_rel_err"] <= chip_smoke.TP_REL_TOL
               for r in range(chip_smoke.TP_GLOO_WORLD))
    assert not build.LAUNCHES or not any(build.LAUNCHES.values())


def test_multi_card_fsdp_rehearsed_over_gloo(cpu_fsdp):
    """``--multi-card``'s phase 3g (the FSDP step, one rank a process on
    data 2 x model 2) over gloo on the CPU: every process's loss, gradient
    and records equal to the simulated ranks'."""
    out = chip_smoke.fsdp_multi_card(cpu_fsdp, 0, 4, backend="gloo")
    assert out["mesh"] == ((2, 2), ("data", "model"))
    assert out["checks"]["grads_rel_err"] <= chip_smoke.TP_REL_TOL
    assert all(out["checks"][f"rank{r}_loss_rel_err"] <= chip_smoke.TP_REL_TOL
               for r in range(4))
