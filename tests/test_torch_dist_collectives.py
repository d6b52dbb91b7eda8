"""The port's syncs over hierarchical mesh axes against the JAX package's
(the counterpart of ``tests/test_collectives.py::test_hierarchical_axes``):
on ``mesh24`` (pod 2 x data 4) over ``("pod", "data")`` and its reverse,
and on ``mesh_dm`` (data 2 x model 4) over ``"data"`` alone (groups of
ranks that share a model index), the butterfly at fanouts 1, 2 and 4,
Rabenseifner, int8, all-to-all, xla and ``tree_sync`` / ``tree_sync_int8``
hold the reference's values within its test's rtol (1e-5; int8 within
``depth max|g| / 127``, the reference's bound) and send the bytes of the
byte model (``grad_sync_bytes`` over the axes' sizes) from every rank.
Also: the lifted rounds, the partial ``ppermute`` (the pipeline's handoff)
and its gradient.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import collectives as ref_coll
from repro_torch.core import butterfly, collectives as coll
from repro_torch.dist.sharding import SimMesh

MESH24 = SimMesh((2, 4), ("pod", "data"))
MESH_DM = SimMesh((2, 4), ("data", "model"))
# (conftest mesh, port mesh, axes synced over)
SETUPS = {
    "pod,data": ("mesh24", MESH24, ("pod", "data")),
    "data,pod": ("mesh24", MESH24, ("data", "pod")),
    "dm/data": ("mesh_dm", MESH_DM, ("data",)),
}


def ref_run(mesh, fn, x):
    """``fn`` inside ``shard_map`` with row ``i`` of ``x`` on device ``i``."""
    spec = P(tuple(mesh.axis_names))
    sm = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(sm)(x))


def sizes(mesh, axes):
    return tuple(mesh.shape[a] for a in axes)


def port_run(mesh, fn, x):
    comm = coll.Communicator(mesh, "cpu")
    return fn(torch.from_numpy(x), comm).numpy(), comm


@pytest.mark.parametrize("fanout", [1, 2, 4])
@pytest.mark.parametrize("method", ["butterfly", "rabenseifner"])
@pytest.mark.parametrize("setup", list(SETUPS))
def test_hierarchical_allreduce_matches_reference(request, setup, method, fanout):
    name, mesh, axes = SETUPS[setup]
    rmesh = request.getfixturevalue(name)
    x = np.random.default_rng(2).normal(size=(8, 5)).astype(np.float32)
    want = ref_run(rmesh, lambda v: jax.lax.psum(v, axes), x)
    if method == "butterfly":
        ref = ref_run(rmesh, lambda v: ref_coll.butterfly_allreduce(v, axes, fanout=fanout), x)
        got, comm = port_run(mesh, lambda v, c: coll.butterfly_allreduce(
            v, c, fanout=fanout, axes=axes), x)
    else:
        ref = ref_run(rmesh, lambda v: ref_coll.butterfly_allreduce_rabenseifner(
            v, axes, fanout=fanout), x)
        got, comm = port_run(mesh, lambda v, c: coll.butterfly_allreduce_rabenseifner(
            v, c, fanout=fanout, axes=axes), x)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    model = coll.grad_sync_bytes(method, sizes(mesh, axes), fanout, 5, 4)
    assert (comm.bytes_sent == model).all(), (comm.bytes_sent, model)


@pytest.mark.parametrize("setup", list(SETUPS))
def test_hierarchical_int8_matches_reference(request, setup):
    name, mesh, axes = SETUPS[setup]
    rmesh = request.getfixturevalue(name)
    x = np.random.default_rng(3).normal(size=(8, 256)).astype(np.float32) * 0.01
    want = ref_run(rmesh, lambda v: jax.lax.psum(v, axes), x)
    ref = ref_run(rmesh, lambda v: ref_coll.butterfly_allreduce_int8(v, axes, fanout=2), x)
    got, comm = port_run(mesh, lambda v, c: coll.butterfly_allreduce_int8(
        v, c, fanout=2, axes=axes), x)
    depth = sum(len(butterfly.digit_plan(n, 2)) for n in sizes(mesh, axes))
    # the reference test's bound: depth x max|acc| / 127 per element
    bound = depth * np.abs(x).sum(axis=0).max() / 127
    assert np.abs(got - want).max() <= bound + 1e-6
    assert np.abs(got - ref).max() <= bound + 1e-6
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2 * np.abs(x).max() / 127)
    model = coll.grad_sync_bytes("butterfly", sizes(mesh, axes), 2, 256, 4, "int8")
    assert (comm.bytes_sent == model).all()


@pytest.mark.parametrize("setup", list(SETUPS))
def test_hierarchical_baselines_match_reference(request, setup):
    """all-to-all (ring shifts axis by axis) and xla (one all-gather over
    the group) against the reference's psum."""
    name, mesh, axes = SETUPS[setup]
    rmesh = request.getfixturevalue(name)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 1
    want = ref_run(rmesh, lambda v: jax.lax.psum(v, axes), x)
    ref = ref_run(rmesh, lambda v: ref_coll.all_to_all_merge(v, axes, op="add"), x)
    got, comm = port_run(mesh, lambda v, c: coll.all_to_all_merge(v, c, op="add", axes=axes), x)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (comm.bytes_sent == coll.grad_sync_bytes("all_to_all", sizes(mesh, axes), 2, 3,
                                                    4)).all()
    got, comm = port_run(mesh, lambda v, c: coll.xla_allreduce(v, c, axes=axes), x)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (comm.bytes_sent == coll.grad_sync_bytes("xla_psum", sizes(mesh, axes), 2, 3,
                                                    4)).all()


@pytest.mark.parametrize("method", coll.GRAD_SYNCS + ("int8",))
def test_hierarchical_tree_sync_matches_reference(mesh24, method):
    axes = ("pod", "data")
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(8, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(8, 3, 2)).astype(np.float32)}}
    spec = P(axes)

    def ref_sync(t):
        if method == "int8":
            return ref_coll.tree_sync_int8(t, axes, fanout=2)
        return ref_coll.tree_sync(t, axes, method=method, fanout=2)

    sm = jax.shard_map(ref_sync, mesh=mesh24, in_specs=spec, out_specs=spec, check_vma=False)
    want = jax.tree.map(np.asarray, jax.jit(sm)(tree))
    comm = coll.Communicator(MESH24, "cpu")
    port_tree = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    if method == "int8":
        got = coll.tree_sync_int8(port_tree, comm, fanout=2, axes=axes)
    else:
        got = coll.tree_sync(port_tree, comm, method=method, fanout=2, axes=axes)
    for g, w, x in ((got["a"], want["a"], tree["a"]), (got["b"]["c"], want["b"]["c"],
                                                     tree["b"]["c"])):
        # int8: the reference test's bound, 3 rounds x max|sum| / 127, over 8
        atol = 3 * np.abs(x).sum(0).max() / 127 / 8 if method == "int8" else 1e-6
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol)
    model = sum(coll.grad_sync_bytes("butterfly" if method == "int8" else method, (2, 4), 2,
                                     n, 4, "int8" if method == "int8" else None)
                for n in (7, 6))
    assert (comm.bytes_sent == model).all()


def test_lifted_rounds():
    """One axis: the lifted rounds are the flat schedule's. Two: each
    round's perms move ranks within their group only, and the stride reads
    each rank's digit on its axis."""
    flat = coll.Communicator(8, "cpu")
    assert flat.rounds(2, ("data",)) == flat.schedule(2).rounds
    assert flat.shifts(("data",)) == flat.shifts(None)
    comm = coll.Communicator(MESH24, "cpu")
    rounds = comm.rounds(2, ("pod", "data"))
    assert [r.digit for r in rounds] == [2, 2, 2]
    assert [r.stride for r in rounds] == [4, 1, 2]
    assert rounds[0].perms == ((4, 5, 6, 7, 0, 1, 2, 3),)
    assert rounds[1].perms == ((1, 0, 3, 2, 5, 4, 7, 6),)
    dm = coll.Communicator(MESH_DM, "cpu")
    (only,) = dm.rounds(4, ("data",))
    assert only.perms == ((4, 5, 6, 7, 0, 1, 2, 3),) and only.stride == 4
    assert dm.group_size(("data",)) == 2 and dm.group_size() == 8
    assert dm.shifts(("data",)) == [(4, 5, 6, 7, 0, 1, 2, 3)]
    assert dm.rings(("model",)) == [((1, 2, 3, 0, 5, 6, 7, 4), 4)]


def test_partial_ppermute_and_its_gradient():
    """A rank whose entry is None sends nothing (no bytes), a rank nobody
    names receives zeros, and autograd carries the copy back."""
    comm = coll.Communicator(4, "cpu")
    x = torch.arange(8.0).reshape(4, 2).requires_grad_(True)
    y = comm.ppermute(x, [1, 2, 3, None])
    assert y.tolist() == [[0, 0], [0, 1], [2, 3], [4, 5]]
    assert comm.bytes_sent.tolist() == [8, 8, 8, 0] and comm.sends.tolist() == [1, 1, 1, 0]
    (g,) = torch.autograd.grad((y * torch.arange(8.0).reshape(4, 2)).sum(), x)
    assert g.tolist() == [[2, 3], [4, 5], [6, 7], [0, 0]]
    with pytest.raises(ValueError):
        comm.ppermute(x, [1, 1, 2, 3])
    with pytest.raises(ValueError):
        comm.ppermute(x, [1, 2, 3])
