"""The syncs, the butterfly train step, the loop and the training CLI on
``torch.distributed``: one spawn of 4 gloo processes for the module
(``test_torch_dist_workers.group_checks``), every check inside it, each
held against the simulated ``Communicator`` on the same inputs here:

* every ``tree_sync`` method (and ``tree_sync_int8``) over one axis and
  over ``("pod", "data")``: each rank's result equal bit for bit to the
  simulated rank's row, and its bytes to the simulated rank's and the
  byte model's;
* a partial ``ppermute`` (the pipeline's handoff) and ``pmean``;
* two butterfly train steps of a reduced arch, each process on its rows:
  every process's parameters equal bit for bit to the simulated-rank
  step's, the loss to 1e-6, the bytes a rank equal;
* three steps of the training loop;
* the last rank raises: the group ends with non-zero exit codes, well
  before the join's timeout.

Then ``launch.train`` under ``torchrun --standalone`` with 2 gloo
processes prints the losses the simulated 2-rank run prints.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch
import test_torch_dist_workers as workers
from repro_torch.core import collectives as coll
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import process
from repro_torch.dist.sharding import SimMesh, rules_for_mesh, sorted_leaves
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, train

TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("group")
    t0 = time.monotonic()
    codes = process.run_group(workers.group_checks, workers.WORLD, (str(out),),
                              timeout_s=TIMEOUT_S)
    elapsed = time.monotonic() - t0
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               if (out / f"rank{r}.pt").exists() else None for r in range(workers.WORLD)]
    return codes, elapsed, results


def ranks_results(group):
    _, _, results = group
    assert all(r is not None for r in results), "a rank saved no results"
    return results


@pytest.fixture
def one_thread():
    """The processes compute with one thread each; a GEMM's sums can
    depend on the thread count, so the simulated run here uses one too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_equal_trees(got, want, what):
    g, w = dict(sorted_leaves(got)), dict(sorted_leaves(want))
    assert list(g) == list(w), what
    for p in w:
        a, b = np.asarray(g[p]), np.asarray(w[p])
        if a.dtype.kind == "V":
            a, b = a.view(np.int16), b.view(np.int16)
        assert a.shape == b.shape and np.array_equal(a, b), (what, p)


def test_group_ends_on_raising_rank(group):
    codes, elapsed, _ = group
    # the first to exit raised (the failing rank, or a waiting one that saw
    # its connection close); the rest are ended, killed if still running
    assert 1 in codes and all(c != 0 for c in codes), codes
    assert elapsed < TIMEOUT_S / 2


@pytest.mark.parametrize("method,fanout", workers.METHODS)
def test_dist_sync_equals_simulated(group, method, fanout):
    results = ranks_results(group)
    comm = coll.Communicator(workers.WORLD, "cpu")
    want = workers.sync(workers.grad_tree(), comm, method, fanout)
    for r, res in enumerate(results):
        got, sent = res[f"sync/{method}/{fanout}"]
        assert_equal_trees(got, workers.rows(want, r), (method, fanout, r))
        assert sent == comm.bytes_sent[r]
    model = sum(coll.grad_sync_bytes("butterfly" if method == "int8" else method,
                                     workers.WORLD, fanout, n, 4,
                                     "int8" if method == "int8" else None) for n in (35, 13))
    assert (comm.bytes_sent == model).all()


@pytest.mark.parametrize("method,fanout", workers.HIERARCHICAL)
def test_dist_hierarchical_sync_equals_simulated(group, method, fanout):
    results = ranks_results(group)
    comm = coll.Communicator(workers.POD_DATA, "cpu")
    want = workers.sync(workers.grad_tree(), comm, method, fanout, ("pod", "data"))
    for r, res in enumerate(results):
        got, sent = res[f"pod_data/{method}/{fanout}"]
        assert_equal_trees(got, workers.rows(want, r), (method, r))
        assert sent == comm.bytes_sent[r]


def test_dist_handoff_and_pmean(group):
    results = ranks_results(group)
    comm = coll.Communicator(workers.WORLD, "cpu")
    x = torch.arange(1.0, workers.WORLD + 1)[:, None].expand(workers.WORLD, 3).contiguous()
    want = comm.ppermute(x, workers.HANDOFF)
    for r, res in enumerate(results):
        got, sent, sends = res["handoff"]
        assert torch.equal(got[0], want[r])
        assert (sent, sends) == (comm.bytes_sent[r], comm.sends[r])
        assert res["pmean"] == pytest.approx(np.mean(range(workers.WORLD)))


def test_dist_butterfly_step_equals_simulated(group, one_thread):
    results = ranks_results(group)
    cfg = workers.step_cfg()
    mesh = SimMesh(workers.WORLD)
    fn = step_mod.build_train_step_butterfly(cfg, mesh, rules_for_mesh(mesh),
                                             method="butterfly", fanout=2,
                                             lr_kw=workers.LR_KW)
    model = api.init_params(cfg, 0, device="cpu")
    state = optim.ADAMW.init(model)
    data = SyntheticLM(cfg, workers.BATCH, workers.SEQ)
    metrics = []
    for s in workers.STEPS:
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
        model, state, m = fn(model, state, batch, s)
        metrics.append(m)
    want = api.to_reference(model)
    for r, res in enumerate(results):
        got, got_metrics = res["step"]
        assert_equal_trees(got, want, ("step", r))
        for gm, wm in zip(got_metrics, metrics):
            assert float(wm["rank_spread"]) == 0.0 and "rank_spread" not in gm
            assert gm["bytes_per_rank"] == wm["bytes_per_rank"] > 0
            assert gm["loss"] == pytest.approx(float(wm["loss"]), rel=1e-6)
            assert gm["grad_norm"] == float(wm["grad_norm"])


def test_dist_loop_equals_simulated(group, one_thread):
    results = ranks_results(group)
    cfg = workers.step_cfg()
    out = train(cfg, workers.BATCH, workers.SEQ,
                LoopConfig(n_steps=3, grad_sync="butterfly", log_every=100,
                           lr_kw=workers.LR_KW), ranks=workers.WORLD, device="cpu")
    for r, res in enumerate(results):
        got, losses = res["loop"]
        assert_equal_trees(got, api.to_reference(out["params"]), ("loop", r))
        np.testing.assert_allclose(losses, out["losses"], rtol=1e-6)


def test_launch_train_under_torchrun(tmp_path):
    """``torchrun --standalone`` (a rendezvous on this host) with 2 gloo
    processes: the losses the simulated 2-rank run prints."""
    torchrun = shutil.which("torchrun") or os.path.join(os.path.dirname(sys.executable),
                                                        "torchrun")
    args = ["--arch", "olmo-1b", "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--grad-sync", "butterfly"]
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("WORLD_SIZE", None)
    run = subprocess.run([torchrun, "--standalone", "--nproc-per-node", "2", "-m",
                          "repro_torch.launch.train", *args], env=env, capture_output=True,
                         text=True, timeout=90, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    sim = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--ranks", "2"], env=env, capture_output=True, text=True,
                         timeout=90, cwd=tmp_path)
    assert sim.returncode == 0, sim.stderr[-2000:]
    done = [ln for ln in run.stdout.splitlines() if ln.startswith("done:")]
    assert done == [ln for ln in sim.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1  # rank 0 alone prints


def test_run_group_returns_when_all_exit_and_kills_at_the_deadline():
    t0 = time.monotonic()
    assert process.run_group(workers.idle, 2, timeout_s=60) == [0, 0]
    assert time.monotonic() - t0 < 30
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        process.run_group(workers.hang, 2, timeout_s=4)
    assert time.monotonic() - t0 < 30  # both killed at the deadline, none left
