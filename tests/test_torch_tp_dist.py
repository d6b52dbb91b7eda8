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
from repro_torch.dist import sharding as shd
from test_torch_train_common import assert_adam_close
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


# -- the SSM and encoder-decoder families: reduced mamba2's gradient and
# GSPMD step (the gate norm's statistic enters every rank's compute, so
# its gradient must be summed over the model ranks: simulated ranks sum it
# by themselves, processes only through the collective) and reduced
# whisper's prefill, in 4 gloo processes against the simulated ranks

LEAF_TOL = 1e-6  # of each leaf's largest magnitude


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families")
    codes = process.run_group(workers.tp_family_checks, workers.WORLD, (str(out),),
                              timeout_s=TIMEOUT_S)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               if (out / f"rank{r}.pt").exists() else None for r in range(workers.WORLD)]
    sim = workers.run_families(collectives.Communicator(workers.MESH, "cpu"), workers.MESH,
                               None)
    return codes, results, sim


def _leaf_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= LEAF_TOL * scale, (what, np.abs(got - want).max(), scale)


def test_family_group_exits_cleanly(families):
    codes, results, _ = families
    assert codes == [0] * workers.WORLD and all(r is not None for r in results)


@pytest.mark.parametrize("rank", range(workers.WORLD))
def test_ssm_gradient_and_step_equal_simulated_ranks(families, rank):
    _, results, sim = families
    got = results[rank]
    np.testing.assert_allclose(got["grad_loss"], sim["grad_loss"], **TOL)
    assert sorted(got["grads"]) == sorted(sim["grads"])
    for p in sim["grads"]:
        _leaf_close(got["grads"][p], sim["grads"][p], p)
    assert got["grad_stats"] == sim["grad_stats"]
    step, want = got["step"], sim["step"]
    np.testing.assert_allclose(step["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(step["grad_norm"], want["grad_norm"], **TOL)
    # AdamW's first update g / (|g| + eps): where |g| is near eps, the
    # processes' and the simulated ranks' float32 roundings of g move it
    # by a visible share of the step (assert_adam_close's bound)
    grads = {}
    for p, g in sim["grads"].items():
        shd.tree_set(grads, tuple(p.split("/")), g)
    assert_adam_close(step["params"], want["params"], [grads], want["lr"], **TOL)
    assert step["stats"] == want["stats"] and step["bytes"] == want["bytes"]


@pytest.mark.parametrize("rank", range(workers.WORLD))
def test_encdec_prefill_equals_simulated_ranks(families, rank):
    _, results, sim = families
    got, groups = results[rank], workers.MESH.shape["data"]
    g = _group_of(rank)
    _leaf_close(got["prefill_logits"], workers.rows_of(sim["prefill_logits"], g, groups),
                "logits")
    for p, t in sim["prefill_cache"].items():
        rows = workers.rows_of(t.movedim(1, 0), g, groups).movedim(0, 1)
        _leaf_close(got["prefill_cache"][p], rows, p)
    assert got["prefill_stats"] == sim["prefill_stats"]
    assert got["prefill_bytes"] == sim["prefill_bytes"]
