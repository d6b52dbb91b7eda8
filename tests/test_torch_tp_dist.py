"""Tensor parallelism on ``torch.distributed``: one spawn of 4 gloo
processes on a (data 2, model 2) mesh (``test_torch_tp_workers``), each
holding its model rank's blocks of the reduced kimi-k2 (dense and MoE
layers, a shared expert, split kv heads, Adafactor) through a
``DistCommunicator``, held here against the same program on simulated
ranks: prefill and decode logits of each process's rows, greedy tokens,
two GSPMD and two butterfly train steps (losses, norms, the gathered
parameters and optimizer state), each within float32 rounding of the
simulated run (gloo's sums take their own order; the GSPMD step sums
the two data groups' gradients where the simulated ranks take the whole
batch's, so Adafactor's squared statistics within 1e-5), and every
process's model-axis record and bytes equal to the simulated ranks'."""

import time

import numpy as np
import pytest
import torch

import test_torch_tp_workers as workers
from test_torch_tp_common import one_torch_thread  # noqa: F401
from repro_torch.core import collectives
from repro_torch.dist import process

TIMEOUT_S = 120.0
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_group")
    t0 = time.monotonic()
    codes = process.run_group(workers.tp_group_checks, workers.WORLD, (str(out),),
                              timeout_s=TIMEOUT_S)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               if (out / f"rank{r}.pt").exists() else None for r in range(workers.WORLD)]
    sim = workers.run(collectives.Communicator(workers.MESH, "cpu"), workers.MESH, None)
    return codes, time.monotonic() - t0, results, sim


def _group_of(rank):
    return int(workers.MESH.coords([rank])[0][0])


def test_group_exits_cleanly(group):
    codes, elapsed, results, _ = group
    assert codes == [0] * workers.WORLD and all(r is not None for r in results)
    assert elapsed < TIMEOUT_S


@pytest.mark.parametrize("rank", range(workers.WORLD))
def test_serving_equals_simulated_ranks(group, rank):
    _, _, results, sim = group
    got, groups = results[rank], workers.MESH.shape["data"]
    g = _group_of(rank)
    for key in ("prefill_logits", "decode_logits"):
        np.testing.assert_allclose(got[key], workers.rows_of(sim[key], g, groups), **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got["tokens"], workers.rows_of(sim["tokens"], g, groups))
    assert got["prefill_stats"] == sim["prefill_stats"]
    assert got["decode_stats"] == sim["decode_stats"]


@pytest.mark.parametrize("kind", ["gspmd", "butterfly"])
@pytest.mark.parametrize("rank", range(workers.WORLD))
def test_train_steps_equal_simulated_ranks(group, rank, kind):
    _, _, results, sim = group
    got, want = results[rank][kind], sim[kind]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    for (pa, a), (pb, b) in zip(workers._leaves(got["params"]), workers._leaves(want["params"])):
        assert pa == pb
        np.testing.assert_allclose(a, b, **TOL, err_msg="/".join(pa))
    assert sorted(got["state"]) == sorted(want["state"])
    for p in want["state"]:
        np.testing.assert_allclose(got["state"][p], want["state"][p], rtol=1e-5, atol=1e-12,
                                   err_msg=p)
    assert got["stats"] == want["stats"] and got["bytes"] == want["bytes"]
