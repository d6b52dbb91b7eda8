"""FSDP (ZeRO-3) on ``torch.distributed``: one spawn of 4 gloo processes
(``test_torch_fsdp_workers``), each holding its data rank's blocks (and
its model rank's) of reduced deepseek-7b on (data 2, model 2) and of
reduced qwen3-moe (Adafactor) on data 4 through a ``DistCommunicator``,
one GSPMD step each, held here against the same step on simulated ranks:
the loss and norm, the gathered parameters and optimizer state within
float32 rounding (gloo sums each gradient's reduce-scatter in its own
order), every record and byte count equal, and each process holding a
1/(data x model) share of every split leaf. Then ``launch.train`` under
``torchrun --standalone`` with 2 gloo processes trains the FSDP step of
reduced deepseek-7b (its FSDP kept) to the losses of the simulated 2-rank
run."""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch
import test_torch_fsdp_workers as workers
from repro_torch.core import collectives
from repro_torch.dist import process
from test_torch_tp_common import one_torch_thread  # noqa: F401
from test_torch_train_common import assert_adam_close

TIMEOUT_S = 120.0
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_group")
    t0 = time.monotonic()
    codes = process.run_group(workers.fsdp_group_checks, workers.WORLD, (str(out),),
                              timeout_s=TIMEOUT_S)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               if (out / f"rank{r}.pt").exists() else None for r in range(workers.WORLD)]
    sim = {arch: workers.run(collectives.Communicator(mesh, "cpu"), arch)
           for arch, mesh in workers.CASES.items()}
    return codes, time.monotonic() - t0, results, sim


def test_group_exits_cleanly(group):
    codes, elapsed, results, _ = group
    assert codes == [0] * workers.WORLD and all(r is not None for r in results)
    assert elapsed < TIMEOUT_S


@pytest.mark.parametrize("arch", sorted(workers.CASES))
@pytest.mark.parametrize("rank", range(workers.WORLD))
def test_step_equals_simulated_ranks(group, rank, arch):
    _, _, results, sim = group
    got, want = results[rank][arch], sim[arch]
    mesh = workers.CASES[arch]
    # a process holds 1 / (data x model) of a leaf split over both axes,
    # 1 / data of one split over the data axes alone; the simulated ranks
    # hold every block
    assert sorted(got["held"]) == sorted(want["held"]) and got["held"]
    for p, (n, parts) in got["held"].items():
        assert n * parts == want["held"][p][0], p
        assert parts in (mesh.shape["data"], mesh.ranks)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    if workers.cfg_of(arch).optimizer == "adamw":
        # AdamW's first update g / (|g| + eps): where |g| nears eps a
        # gradient's last bits move it by a share of the step
        assert_adam_close(got["params"], want["params"], [want["grads"]], want["lr"], **TOL)
    else:
        for (pa, a), (pb, b) in zip(workers._leaves(got["params"]),
                                    workers._leaves(want["params"])):
            assert pa == pb
            np.testing.assert_allclose(a, b, **TOL, err_msg="/".join(pa))
    assert sorted(got["state"]) == sorted(want["state"])
    for p, w in want["state"].items():  # within 1e-6 of each leaf's largest
        w = w.double()
        err = float((got["state"][p].double() - w).abs().max())
        assert err <= 1e-6 * (float(w.abs().max()) or 1.0), (p, err)
    assert got["fsdp_stats"] == want["fsdp_stats"] and got["tp_stats"] == want["tp_stats"]
    assert got["bytes"] == want["bytes"] > 0


def test_launch_train_fsdp_under_torchrun(tmp_path):
    """``torchrun --standalone`` with 2 gloo processes: reduced deepseek-7b
    with its FSDP rules (``--grad-sync xla``) holds half of each split
    leaf a process and prints the losses of the simulated 2-rank run."""
    torchrun = shutil.which("torchrun") or os.path.join(os.path.dirname(sys.executable),
                                                        "torchrun")
    args = ["--arch", "deepseek-7b", "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("WORLD_SIZE", None)
    script = os.path.abspath(workers.__file__)
    run = subprocess.run([torchrun, "--standalone", "--nproc-per-node", "2", script, *args],
                         env=env, capture_output=True, text=True, timeout=90, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    sim = subprocess.run([sys.executable, script, *args, "--ranks", "2"], env=env,
                         capture_output=True, text=True, timeout=90, cwd=tmp_path)
    assert sim.returncode == 0, sim.stderr[-2000:]
    done = [ln for ln in run.stdout.splitlines() if ln.startswith("done:")]
    assert done == [ln for ln in sim.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1  # rank 0 alone prints
    held = sorted(ln for ln in run.stdout.splitlines() if ln.startswith("fsdp rank"))
    whole = [ln for ln in sim.stdout.splitlines() if ln.startswith("fsdp rank")]
    assert len(held) == 2 and len(whole) == 1
    n_proc = {int(ln.split()[-2]) for ln in held}
    assert len(n_proc) == 1 and 2 * n_proc.pop() == int(whole[0].split()[-2])
    assert all(" 2 data ranks" in ln for ln in held + whole)
