"""The port's GPipe pipeline against the JAX package's (the counterparts of
``tests/test_pipeline.py``'s three tests), on a ``(stage 4, data 2)`` mesh:
the forward equal to the reference's pipelined apply and to the sequential
stack within its test's rtol 2e-5, atol 2e-6; the weight gradient of
``sum(out ** 2)`` within rtol 5e-4, atol 5e-6 of the reference's; and,
for the HLO bubble check, the ``Communicator``'s count: ``M + S - 1``
handoff messages from every stage but the last, each one device's block,
none from the last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import pipeline as ref_pipeline
from repro_torch.core.collectives import Communicator
from repro_torch.dist import pipeline
from repro_torch.dist.sharding import SimMesh

MESH = SimMesh((4, 2), ("stage", "data"))


@pytest.fixture(scope="module")
def mesh_stage():
    return jax.make_mesh((4, 2), ("stage", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def ref_stage_fn(params, x):
    def body(c, w):
        return jnp.tanh(c @ w), None

    y, _ = jax.lax.scan(body, x, params)
    return y


def stage_fn(params, x):
    for w in params:
        x = torch.tanh(x @ w)
    return x


def sequential(stacked, mbs):
    outs = []
    for x in mbs:
        for w in stacked:
            x = torch.tanh(x @ w)
        outs.append(x)
    return torch.stack(outs)


def inputs(seed, n_layers, d, m, mb):
    rng = np.random.default_rng(seed)
    stacked = (rng.normal(size=(n_layers, d, d)) * 0.3).astype(np.float32)
    mbs = rng.normal(size=(m, mb, d)).astype(np.float32)
    return stacked, mbs


def test_pipeline_matches_sequential(mesh_stage):
    stacked, mbs = inputs(0, 8, 16, 6, 4)  # 4 stages x 2 layers each
    want = np.asarray(jax.jit(ref_pipeline.build_pipelined_apply(mesh_stage, ref_stage_fn))(
        stacked, mbs))
    got = pipeline.build_pipelined_apply(MESH, stage_fn)(torch.from_numpy(stacked),
                                                         torch.from_numpy(mbs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    seq = sequential(torch.from_numpy(stacked), torch.from_numpy(mbs))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5, atol=2e-6)


def test_pipeline_differentiable(mesh_stage):
    """grad through the pipeline == the reference's grad through its
    pipeline, and == grad through sequential execution."""
    stacked, mbs = inputs(1, 4, 8, 3, 2)
    fn = ref_pipeline.build_pipelined_apply(mesh_stage, ref_stage_fn)
    want = np.asarray(jax.jit(jax.grad(lambda w: jnp.sum(fn(w, mbs) ** 2)))(stacked))
    w = torch.from_numpy(stacked).requires_grad_(True)
    apply = pipeline.build_pipelined_apply(MESH, stage_fn)
    (got,) = torch.autograd.grad((apply(w, torch.from_numpy(mbs)) ** 2).sum(), w)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-6)
    (seq,) = torch.autograd.grad((sequential(w, torch.from_numpy(mbs)) ** 2).sum(), w)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("sizes,names", [((4, 2), ("stage", "data")),
                                         ((2, 4), ("data", "stage")),
                                         ((4,), ("stage",))])
def test_pipeline_bubble_structure(sizes, names):
    """M + S - 1 ticks of handoffs: each stage but the last sends one
    device block (mb / D rows of d float32) a tick; the last sends none."""
    mesh = SimMesh(sizes, names)
    s, m, mb, d = mesh.shape["stage"], 6, 4, 16
    stacked, mbs = inputs(0, 8, d, m, mb)
    comm = Communicator(mesh, "cpu")
    got = pipeline.build_pipelined_apply(mesh, stage_fn)(
        torch.from_numpy(stacked), torch.from_numpy(mbs), comm)
    seq = sequential(torch.from_numpy(stacked), torch.from_numpy(mbs))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5, atol=2e-6)
    stage = mesh.group_index(np.arange(mesh.ranks), ("stage",))
    rows = mb // (mesh.ranks // s)
    for r in range(mesh.ranks):
        ticks = m + s - 1 if stage[r] < s - 1 else 0
        assert comm.sends[r] == ticks
        assert comm.bytes_sent[r] == ticks * rows * d * 4


def test_pipeline_refuses_uneven_splits():
    apply = pipeline.build_pipelined_apply(MESH, stage_fn)
    with pytest.raises(ValueError):
        apply(torch.zeros(6, 4, 4), torch.zeros(2, 2, 4))  # 6 layers over 4 stages
    with pytest.raises(ValueError):
        apply(torch.zeros(8, 4, 4), torch.zeros(2, 3, 4))  # 3 rows over 2 data ranks
