"""The port's sparse and adaptive syncs over hierarchical mesh axes against
the JAX package's: on ``mesh24`` (pod 2 x data 4) over ``("pod", "data")``
and over ``("data",)`` alone (each pod a group of its own), at fanouts 2
and 4, the OR syncs (``butterfly_or_sparse`` / ``_adaptive``) and the
monoid syncs (``butterfly_reduce_sparse`` / ``_adaptive``: MIN against a
shared reference, ADD in delta mode) equal the reference exactly.  Inputs
whose pods straddle the capacity make the groups of ``("data",)`` take
different branches, and every rank's bytes equal the byte model of the
branch its group ran (the sizes of the axes in order).  Also the
hierarchical byte models themselves and the per-group maxima."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import collectives as ref_coll
from repro.core import monoid as ref_mono
from repro_torch.core import butterfly, collectives as coll
from repro_torch.core import monoid as mono
from repro_torch.dist.sharding import SimMesh

MESH24 = SimMesh((2, 4), ("pod", "data"))
NW = 256
CAP = 16
THRESHOLD = 0.02
AXES = {"pod,data": ("pod", "data"), "data": ("data",)}
# active words a rank, pod 0 then pod 1: both under the capacity, or
# pod 1 over it (the straddle)
CASES = {"low": (3, 3), "straddle": (3, 40)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _u32(t):
    return t.contiguous().view(torch.uint32).numpy()


def _ref_run(mesh, fn, x):
    """``fn`` on each rank's ``[W]`` row, row ``i`` on device ``i``."""
    spec = P(tuple(mesh.axis_names))
    sm = jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=spec,
                       out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(sm)(x))


def _ref_sync(mesh24, fn, x, axes, case):
    """The reference's sync of ``x`` over ``axes``.  Where the pods of
    ``("data",)`` straddle the capacity they take different ``lax.cond``
    branches, each holding collectives, which XLA's CPU runtime aborts on
    within one program; each pod then runs the reference on a mesh of its
    own four devices (one ``data`` axis), which is what its group
    computes."""
    if axes == ("data",) and case == "straddle":
        mesh4 = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        return np.concatenate([_ref_run(mesh4, fn, x[:4]), _ref_run(mesh4, fn, x[4:])])
    return _ref_run(mesh24, fn, x)


def _words(case, seed, base=None):
    """uint32[8, NW]: each rank's ``CASES[case]`` active words (nonzero, or
    lowered below ``base`` when given)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((8, NW), np.uint32) if base is None else np.tile(base, (8, 1))
    for r in range(8):
        n = CASES[case][r // 4]
        ii = rng.choice(NW, size=n, replace=False)
        if base is None:
            x[r, ii] = rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        else:
            x[r, ii] = (base[ii] * rng.random(n)).astype(np.uint32)
    return x


def _groups(axes):
    """The ranks of each group over ``axes`` on MESH24."""
    return [list(range(8))] if axes == ("pod", "data") else [[0, 1, 2, 3], [4, 5, 6, 7]]


def _model(axes, fanout, sparse):
    sizes = tuple(MESH24.shape[a] for a in axes)
    if sparse:
        return butterfly.bytes_per_node_sparse(sizes, fanout, CAP, NW)
    return butterfly.bytes_per_node_allreduce(sizes, fanout, NW * 4)


def _check_bytes(comm, axes, fanout, go_sparse):
    """Every rank's bytes: its group's branch's model."""
    want = np.zeros(8, np.int64)
    for grp in _groups(axes):
        want[grp] = _model(axes, fanout, go_sparse(grp))
    assert comm.bytes_sent.tolist() == want.tolist()


def _popcount(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fanout", [2, 4])
@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("kind", ["sparse", "adaptive"])
def test_or_sync_over_axes_matches_reference(mesh24, kind, axes, fanout, case):
    axes = AXES[axes]
    x = _words(case, seed=fanout * 10 + len(axes))
    if kind == "sparse":
        ref_fn = lambda v: ref_coll.butterfly_or_sparse(v, axes, fanout=fanout, capacity=CAP)
        kw = dict(capacity=CAP)
        port_fn = coll.butterfly_or_sparse
    else:
        ref_fn = lambda v: ref_coll.butterfly_or_adaptive(
            v, axes, fanout=fanout, capacity=CAP, density_threshold=THRESHOLD)
        kw = dict(capacity=CAP, density_threshold=THRESHOLD)
        port_fn = coll.butterfly_or_adaptive
    comm = coll.Communicator(MESH24, "cpu")
    got = _u32(port_fn(_t(x), comm, fanout=fanout, axes=axes, **kw))
    np.testing.assert_array_equal(got, _ref_sync(mesh24, ref_fn, x, axes, case))
    for grp in _groups(axes):
        for r in grp:
            np.testing.assert_array_equal(got[r], np.bitwise_or.reduce(x[grp], axis=0))

    def go_sparse(grp):
        fits = max(np.count_nonzero(x[r]) for r in grp) <= CAP
        if kind == "adaptive":
            fits &= max(_popcount(x[r]) for r in grp) <= coll.bits_limit(NW, THRESHOLD)
        return fits

    _check_bytes(comm, axes, fanout, go_sparse)
    branches = {go_sparse(g) for g in _groups(axes)}
    if case == "straddle" and axes == ("data",):
        assert branches == {True, False}  # the pods took different branches
    if case == "straddle" and axes == ("pod", "data"):
        assert branches == {False}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fanout", [2, 4])
@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("kind", ["sparse", "adaptive"])
@pytest.mark.parametrize("monoid", ["min", "add_u32"])
def test_monoid_sync_over_axes_matches_reference(mesh24, monoid, kind, axes, fanout, case):
    """MIN against a shared reference buffer (remerge mode: every change
    lowers a word of ``ref``) and ADD_U32 in delta mode (``ref=None``)."""
    axes = AXES[axes]
    rng = np.random.default_rng(fanout + len(axes))
    if monoid == "min":
        ref = rng.integers(1 << 20, 2**32, size=NW, dtype=np.uint64).astype(np.uint32)
        x = _words(case, seed=fanout, base=ref)
        pm, rm, host = mono.MIN_U32, ref_mono.MIN_U32, np.minimum
        ref_kw, port_kw = dict(ref=ref), dict(ref=_t(ref))
    else:
        ref = np.zeros(NW, np.uint32)
        x = _words(case, seed=fanout + 1)
        pm, rm, host = mono.ADD_U32, ref_mono.ADD_U32, np.add
        ref_kw, port_kw = {}, {}
    extra = {} if kind == "sparse" else dict(density_threshold=THRESHOLD)
    ref_fn = getattr(ref_coll, f"butterfly_reduce_{kind}")
    port_fn = getattr(coll, f"butterfly_reduce_{kind}")
    want = _ref_sync(mesh24, lambda v: ref_fn(v, axes, rm, fanout=fanout, capacity=CAP,
                                              **ref_kw, **extra), x, axes, case)
    comm = coll.Communicator(MESH24, "cpu")
    got = _u32(port_fn(_t(x), comm, pm, fanout=fanout, capacity=CAP, axes=axes,
                       **port_kw, **extra))
    np.testing.assert_array_equal(got, want)
    for grp in _groups(axes):
        for r in grp:
            np.testing.assert_array_equal(got[r], host.reduce(x[grp], axis=0, dtype=np.uint32))

    def go_sparse(grp):
        changed = max(np.count_nonzero(x[r] != ref) for r in grp)
        fits = changed <= CAP
        if kind == "adaptive":
            fits &= changed <= int(THRESHOLD * NW)
        return fits

    _check_bytes(comm, axes, fanout, go_sparse)


def test_one_axis_groups_equal_the_whole_mesh():
    """``axes=None`` (all ranks as one axis) and the axes that cover the
    mesh decide alike: the busiest rank of the whole mesh."""
    x = _words("straddle", seed=3)
    c1, c2 = coll.Communicator(MESH24, "cpu"), coll.Communicator(8, "cpu")
    a = coll.butterfly_or_sparse(_t(x), c1, fanout=2, capacity=CAP, axes=("pod", "data"))
    b = coll.butterfly_or_sparse(_t(x), c2, fanout=2, capacity=CAP)
    assert torch.equal(a, b) and (c1.bytes_sent == c2.bytes_sent).all()
    assert c1.bytes_sent.tolist() == [butterfly.bytes_per_node_allreduce(8, 2, NW * 4)] * 8


@pytest.mark.parametrize("axes", [None, ("data",), ("pod",), ("pod", "data")])
def test_group_max_is_the_groups_pmax(axes):
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 100, 8), rng.integers(0, 100, 8)
    comm = coll.Communicator(MESH24, "cpu")
    got = comm.group_max([torch.as_tensor(a), torch.as_tensor(b)], axes)
    gid = comm.group_ids(axes)
    for k, v in enumerate((a, b)):
        assert got[k].tolist() == [int(v[gid == g].max()) for g in gid]
    assert len(set(gid.tolist())) == {None: 1, ("data",): 2, ("pod",): 4,
                                      ("pod", "data"): 1}[axes]


# --- byte models over the axes' sizes ---------------------------------------


@pytest.mark.parametrize("fanout", [1, 2, 4])
def test_axes_byte_models(fanout):
    for sizes in [(2, 4), (4, 4), (4, 2), (2, 2, 2), (3, 4), (1, 8)]:
        g = int(np.prod(sizes))
        plan = [d for a in sizes for d in butterfly.digit_plan(a, fanout)]
        assert butterfly.axes_digit_plan(sizes, fanout) == plan
        assert butterfly.messages_per_node(sizes, fanout) == sum(d - 1 for d in plan)
        assert butterfly.bytes_per_node_allreduce(sizes, fanout, 100) == \
            sum(butterfly.bytes_per_node_allreduce(a, fanout, 100) for a in sizes)
        caps, c = [], 16
        for d in plan:  # the digit product carries across the axes
            caps.append(min(c, 200))
            c *= d
        assert butterfly.sparse_round_capacities(sizes, fanout, 16, 200) == caps
        assert butterfly.bytes_per_node_sparse(sizes, fanout, 16, 200) == \
            sum((d - 1) * cap * 8 for d, cap in zip(plan, caps))
        assert butterfly.bytes_per_node_all_to_all(sizes, 100) == sum(a - 1 for a in sizes) * 100
        assert butterfly.bytes_per_node_allgather(sizes, 100) == (g - 1) * 100
        # a buffer of a multiple of the group's ranks: Rabenseifner's
        # reduce-scatter over the axes costs what the group's costs
        assert butterfly.bytes_per_node_rabenseifner(sizes, fanout, 100 * g) == \
            butterfly.bytes_per_node_rabenseifner(g, fanout, 100 * g) == 2 * (g - 1) * 100
        # int p: the one-axis models
        assert butterfly.bytes_per_node_all_to_all(g, 100) == (g - 1) * 100
        assert butterfly.axes_digit_plan(g, fanout) == butterfly.digit_plan(g, fanout)


def test_pod4_data4_fanout4_matches_one_axis_but_all_to_all():
    """(pod 4, data 4) at fanout 4 has the digit plans [4] and [4], the
    one-axis P = 16 plan [4, 4]: every sync's bytes but all-to-all's are
    the one-axis run's, and all-to-all ships 6 buffers a rank, not 15
    (scale 23, P = 16: 279,296 words)."""
    nw, nb, cap = 279_296, 279_296 * 4, 4364
    assert butterfly.axes_digit_plan((4, 4), 4) == butterfly.digit_plan(16, 4) == [4, 4]
    assert butterfly.bytes_per_node_allreduce((4, 4), 4, nb) == \
        butterfly.bytes_per_node_allreduce(16, 4, nb)
    assert butterfly.bytes_per_node_sparse((4, 4), 4, cap, nw) == \
        butterfly.bytes_per_node_sparse(16, 4, cap, nw)
    assert butterfly.bytes_per_node_allgather((4, 4), nb) == 15 * nb
    assert butterfly.bytes_per_node_all_to_all((4, 4), nb) == 6 * 1_117_184
    assert butterfly.bytes_per_node_all_to_all(16, nb) == 15 * 1_117_184


def test_grad_sync_bytes_unchanged_by_shared_models():
    """``grad_sync_bytes`` on the shared models keeps its values."""
    for sizes in [8, (2, 4), (4, 2)]:
        s = (sizes,) if isinstance(sizes, int) else sizes
        g = int(np.prod(s))
        assert coll.grad_sync_bytes("all_to_all", sizes, 2, 5, 4) == sum(a - 1 for a in s) * 20
        assert coll.grad_sync_bytes("xla_psum", sizes, 2, 5, 4) == (g - 1) * 20
        assert coll.grad_sync_bytes("butterfly", sizes, 4, 5, 4) == \
            sum(butterfly.messages_per_node(a, 4) for a in s) * 20
        assert coll.grad_sync_bytes("butterfly", sizes, 2, 5, 4, "int8") == \
            sum(butterfly.messages_per_node(a, 2) for a in s) * 9
