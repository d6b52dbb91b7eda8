"""chip_smoke.py's LM training phase (phase 3b) rehearsed on the CPU: the
whole phase at reduced configs (bfloat16 with remat for the trained model,
as on the card) with the CUDA calls stubbed, and its checks shown to fail
where the path is wrong.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train import loop  # noqa: E402


@pytest.fixture()
def cpu_train(monkeypatch):
    """The CUDA calls of phase 3b made no-ops, the trained model qwen3's
    reduced config in bfloat16 with remat, the shapes cut down."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    full = configs.get_config

    def small(name):
        cfg = configs.reduced(full(name))
        if name == chip_smoke.LM_ARCH:
            cfg = dataclasses.replace(cfg, remat=True, param_dtype="bfloat16",
                                      compute_dtype="bfloat16", train_microbatches=2)
        return cfg

    monkeypatch.setattr(configs, "get_config", small)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "TRAIN_LR", {"peak": 1e-2, "warmup": 1, "total": 3})
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


def test_train_phase_rehearsed_on_the_cpu(cpu_train):
    out = chip_smoke.run_train(cpu_train, 0, profile=True)
    pub = out["published"]
    assert len(pub["losses"]) == 3 and pub["losses"][-1] < pub["losses"][0]
    assert pub["model_flops"] == 6 * pub["remat_flops"] / 2 > 0
    # phase 3d(a): the real step's flops == the fake step's, exactly
    roof = pub["roofline"]
    assert roof["flops"] == roof["fake_flops"] > 0 and roof["step_time_est_ms"] > 0
    assert pub["profile"]["launches"] == 0  # no graph kernel on this path
    sync = out["sync"]
    for method, fanout in chip_smoke.SYNC_CASES:
        assert sync[f"{method} fanout {fanout}"]["rel_err"] <= chip_smoke.SYNC_REL_TOL
    assert sync["butterfly fanout 2"]["rank_spread"] == 0.0
    assert 0.24 < sync["int8 fanout 2"]["byte_ratio"] < 0.3
    assert sync["step"]["bytes_per_rank"] == sync["butterfly fanout 2"]["bytes_per_rank"]
    assert out["restart"]["ckpt_bytes"] > 0 and out["restart"]["layers"] == 2
    assert set(out["reduced"]) == set(configs.ARCH_NAMES)
    assert all(r["loss_rel_err"] == 0.0 for r in out["reduced"].values())


def test_sync_check_refuses_a_wrong_sum(cpu_train, monkeypatch):
    """A sync that drops a rank's gradient fails the comparison with the
    one-device gradient."""
    real = collectives.sync_leaf

    def lossy(g, comm, **kw):
        g = g.clone()
        g[1] = 0
        return real(g, comm, **kw)

    monkeypatch.setattr(collectives, "sync_leaf", lossy)
    model = chip_smoke.train_published(cpu_train, 0, profile=False)[1]
    with pytest.raises(AssertionError, match="rel err"):
        chip_smoke.sync_full_width(model, cpu_train)


def test_restart_check_refuses_a_lossy_restore(cpu_train, monkeypatch):
    """A restore that loses the moments fails the bit-for-bit comparison."""
    from repro_torch.checkpoint import ckpt

    real = ckpt.restore

    def forgetful(path, templates, **kw):
        step, trees = real(path, templates, **kw)
        trees["opt_state"]["m"]["embed"]["tok"].zero_()
        return step, trees

    monkeypatch.setattr(loop.ckpt, "restore", forgetful)
    with pytest.raises(AssertionError, match="restart"):
        chip_smoke.restart_check(cpu_train, 0)


def test_adam_close_holds_ill_conditioned_elements_to_the_step_bound():
    g = torch.full((200,), 1e-3)
    g[1], g[2] = 1e-9, 0.0  # nonzero and small: ill-conditioned; zero: not
    want = {"w": np.ones(200, np.float32)}

    def moved(**at):
        w = np.ones(200, np.float32)
        for i, d in at.items():
            w[int(i[1:])] += d
        return {"w": w}

    res = chip_smoke.adam_close("x", moved(i0=5e-6, i1=1e-3), want, [{"w": g}], 1e-3, 1e-5)
    assert res["ill_conditioned"] == 1 and res["tol_share"] < 1
    with pytest.raises(AssertionError, match="outside"):
        chip_smoke.adam_close("x", moved(i2=1e-4), want, [{"w": g}], 1e-3, 1e-5)
    with pytest.raises(AssertionError, match="ill-conditioned elements"):
        chip_smoke.adam_close("x", moved(i1=0.01), want, [{"w": g}], 1e-3, 1e-5)
    g[:10] = 1e-9  # 5 % of the model: too many to hold to the step bound
    with pytest.raises(AssertionError, match="of 200 elements"):
        chip_smoke.adam_close("x", want, want, [{"w": g}], 1e-3, 1e-5)
