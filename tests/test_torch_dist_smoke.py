"""chip_smoke.py's multi-device phase (phase 3c) rehearsed on the CPU: the
whole phase at reduced configs with the CUDA calls stubbed (the placement,
the elastic restore of phase 3b(c)'s checkpoint, GPipe, and the gradient
sync in 4 gloo processes on the CPU), and its checks shown to fail where
the path is wrong.
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import test_torch_dist_workers as workers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


@pytest.fixture()
def cpu_lm(monkeypatch):
    """The CUDA calls of phases 3b and 3c made no-ops, the LM qwen3's reduced
    config with 8 layers (two a GPipe stage), the shapes cut down, one
    thread in each spawned process."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    full = configs.get_config

    def small(name):
        cfg = configs.reduced(full(name))
        if name == chip_smoke.LM_ARCH:
            cfg = dataclasses.replace(cfg, n_layers=8, train_microbatches=2)
        return cfg

    monkeypatch.setattr(configs, "get_config", small)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 8)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "RESTART_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "RESTART_FAIL", 3)
    monkeypatch.setattr(chip_smoke, "RESTART_EVERY", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_LR", {"peak": 1e-2, "warmup": 1, "total": 3})
    monkeypatch.setattr(chip_smoke, "GPIPE_ROWS", 8)
    monkeypatch.setattr(chip_smoke, "GPIPE_REPS", 1)
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


@pytest.fixture()
def cpu_multi(cpu_lm, tmp_path):
    """``cpu_lm`` with the restart's checkpoint written first, as phase 3b
    writes it."""
    chip_smoke.restart_check(cpu_lm, 0, str(tmp_path))
    build.reset_launches()
    return cpu_lm, os.path.join(str(tmp_path), "ck")


def test_multi_phase_rehearsed_on_the_cpu(cpu_multi):
    dev, ck = cpu_multi
    out = chip_smoke.run_multi(dev, 0, ck)
    place = out["placement"]
    for mesh in ("production", "multi_pod"):
        assert 0 < place[mesh]["params"]["split_share"] <= 1
        assert place[mesh]["params"]["device_bytes"] < place[mesh]["params"]["bytes"]
    assert place["placed"]["split_leaves"] > 0
    for label, *_ in chip_smoke.RESTORE_MESHES:
        assert out["restore"][label]["split_leaves"] > 0
        assert out["restore"][label]["step"] == chip_smoke.RESTART_STEPS
    gp = out["gpipe"]
    assert gp["ticks"] == chip_smoke.GPIPE_MICRO + chip_smoke.GPIPE_STAGES - 1
    assert gp["stage_bytes"][-1] == 0 and gp["forward"]["tol_share"] <= 1
    dist = out["dist"]
    assert set(dist["methods"]) == {f"{m} fanout {f}" for m, f in chip_smoke.DIST_CASES}
    for label, rec in dist["methods"].items():
        assert rec["bytes"] == rec["model_bytes"] > 0
        assert rec["bit_equal"] and rec["rel_err"] == 0.0, label
    assert dist["step"]["bytes"] == dist["step"]["sim_bytes"] > 0


def test_block_slices_agree_with_place():
    """The script's own reading of the JAX layout against the port's."""
    sizes, names = (2, 3, 2), ("pod", "data", "model")
    mesh = shd.SimMesh(sizes, names)
    x = torch.arange(12 * 6 * 4).reshape(12, 6, 4)
    for spec in ((("pod", "data"), "model"), (None, "data", "model"), ("model",), ()):
        shards = shd.place(x, spec, mesh)
        chip_smoke.check_shards(str(spec), x, shards, spec, sizes, names)
    with pytest.raises(AssertionError, match="block"):
        chip_smoke.check_shards("swapped", x, shd.place(x, ("model",), mesh).flip(0),
                                ("model",), sizes, names)


def test_bits_checksum_sees_one_bit():
    x = torch.randn(3000)
    y = x.clone()
    y.view(torch.int32)[1234] ^= 1
    assert chip_smoke.bits_checksum(x) == chip_smoke.bits_checksum(x.clone())
    assert chip_smoke.bits_checksum(x) != chip_smoke.bits_checksum(y)
    assert chip_smoke.bits_checksum(x.bfloat16()) != chip_smoke.bits_checksum(y.bfloat16()) \
        or torch.equal(x.bfloat16(), y.bfloat16())


def test_gpipe_check_refuses_a_wrong_handoff(cpu_lm, monkeypatch):
    """A pipeline that hands each stage's output to the wrong stage fails
    the comparison with the sequential stack."""
    from repro_torch.core.collectives import Communicator

    real = Communicator.ppermute

    def crossed(self, x, perm, out=None):
        return real(self, x.flip(0), perm, out)

    monkeypatch.setattr(Communicator, "ppermute", crossed)
    with pytest.raises(AssertionError, match="gpipe forward"):
        chip_smoke.gpipe(cpu_lm, 0)


def test_dist_check_holds_a_differing_rank_to_the_tolerance(cpu_lm):
    """A rank whose synced leaves differ from the simulated rank's by an ulp
    (its checksums differ) sends them to rank 0, which holds them within
    the relative tolerance: the phase passes, not bit for bit."""
    out = chip_smoke.dist_sync(cpu_lm, 0, child=workers.nudged_dist_child)
    for label, rec in out["methods"].items():
        assert not rec["bit_equal"] and rec["mismatched"] > 0, label
        assert 0 < rec["rel_err"] <= chip_smoke.SYNC_REL_TOL, label
