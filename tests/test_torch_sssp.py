"""PyTorch port, SSSP: distances, iteration counts and edges relaxed equal
the JAX package's ``distributed_sssp`` bit for bit, and the distances equal
host Dijkstra, on every family of ``tests/test_traversal.py`` and across
butterfly/sparse/adaptive x P in {1, 2, 8}, the all-to-all and xla syncs,
delta buckets, and words whose sums wrap uint32."""

import jax
import numpy as np
import pytest
import torch

from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.traversal import sssp as ref_sssp
from repro_torch.core import collectives
from repro_torch.graph import csr, generators, partition
from repro_torch.traversal import sssp

W = 16
GRAPHS = {
    "kron": lambda gen: gen.kronecker(9, 8, seed=1, max_weight=W),
    "urand": lambda gen: gen.uniform_random(600, 3000, seed=2, max_weight=W),
    "torus": lambda gen: gen.torus_2d(16, max_weight=W, seed=3),
    "path": lambda gen: gen.path_graph(96, max_weight=W, seed=4),
    "star": lambda gen: gen.star_graph(64, max_weight=W, seed=5),
}
SYNCS = ("butterfly", "sparse", "adaptive")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(p):
    return jax.make_mesh((p,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def _port(rpg):
    return partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                    rpg.arrays())


_graphs = {}


def _graph(name):
    if name not in _graphs:
        _graphs[name] = GRAPHS[name](ref_gen)
    return _graphs[name]


def _root(g, seed=0):
    return int(ref_csr.largest_component_root(g, np.random.default_rng(seed)))


def _check(name, p, **kw):
    g = _graph(name)
    rpg = ref_part.partition_1d(g, p)
    root = _root(g)
    want = ref_sssp.distributed_sssp(rpg, _mesh(p), root,
                                     ref_sssp.SSSPConfig(axes=("data",), fanout=4, **kw))
    got = sssp.distributed_sssp(_port(rpg), root, sssp.SSSPConfig(fanout=4, **kw),
                                device="cpu")
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{name} P={p} {kw}")
    np.testing.assert_array_equal(got[0], ref_sssp.sssp_reference(g, root))
    assert got[1:] == want[1:], (got[1:], want[1:])
    return got


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sssp_matches_reference_per_family(name):
    _check(name, 8, sync="adaptive")


@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("p", [1, 2, 8])
def test_sssp_sync_by_partition_count(sync, p):
    _check("kron", p, sync=sync)


@pytest.mark.parametrize("sync", ["all_to_all", "xla"])
def test_sssp_dense_baselines(sync):
    _check("torus", 8, sync=sync)


@pytest.mark.parametrize("sync", ["butterfly", "adaptive"])
def test_sssp_delta_buckets(sync):
    """delta-stepping buckets converge to the same distances; the empty
    rounds that advance a bucket count as iterations, as in the
    reference."""
    got = _check("torus", 8, sync=sync, delta=8)
    plain = _check("torus", 8, sync=sync)
    assert got[1] > plain[1]


def test_sssp_sparse_capacity_forces_the_sparse_wire():
    """A capacity large enough that no round falls back: every iteration
    ships compact pairs, and still equals the dense butterfly."""
    _check("path", 8, sync="sparse", sparse_capacity=4096)


def test_sssp_saturates_instead_of_wrapping():
    """Weights near 2^32: a sum that would wrap uint32 saturates to
    UNREACHED as the reference's wrap check does; a signed compare would
    take the wrapped (or the sentinel's -1) value as the shortest."""
    src = np.array([0, 1, 0, 2])
    dst = np.array([1, 2, 3, 3])
    w = np.array([2**31 + 5, 2**31, 7, 2**32 - 2], dtype=np.uint64)
    rg = ref_csr.from_edges(src, dst, 4, weights=w)
    tg = csr.from_edges(src, dst, 4, weights=w)
    want = ref_sssp.sssp_reference(rg, 0)
    for p in (1, 2):
        rpg = ref_part.partition_1d(rg, p)
        ref = ref_sssp.distributed_sssp(rpg, _mesh(p), 0, ref_sssp.SSSPConfig(fanout=2))
        got = sssp.distributed_sssp(partition.partition_1d(tg, p), 0, device="cpu")
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    # 0 -> 1 is 2^31 + 5; 1 -> 2 would wrap past 2^32, so 2 is reached
    # through 3: 7 + (2^32 - 2) wraps too, leaving 2 unreached
    assert got[0][:4].tolist() == [0, 2**31 + 5, sssp.UNREACHED, 7]
    np.testing.assert_array_equal(ref[0], want)


def test_sssp_bytes_equal_the_byte_model():
    """Dense butterfly: every iteration ships the distance buffer
    (digit - 1) times a round, 4 bytes a word."""
    from repro_torch.core import butterfly

    g = GRAPHS["kron"](generators)
    pg = partition.partition_1d(g, 8)
    comm = collectives.Communicator(8, "cpu")
    fn = sssp.build_sssp_fn(pg, sssp.SSSPConfig(fanout=4), device="cpu")
    from repro_torch.core import bfs

    _, iters, _ = fn(bfs.place_arrays(pg, device="cpu"), _root(g), comm)
    want = iters * butterfly.bytes_per_node_allreduce(8, 4, sssp.dist_rows(pg) * 4)
    assert comm.bytes_sent.tolist() == [want] * 8


def test_sssp_rejects_unweighted_and_bad_config():
    pg = partition.partition_1d(generators.kronecker(9, 8, seed=1), 2)
    with pytest.raises(ValueError, match="weighted"):
        sssp.build_sssp_fn(pg, sssp.SSSPConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown distance sync"):
        sssp.SSSPConfig(sync="rabenseifner")
    with pytest.raises(ValueError, match="delta"):
        sssp.SSSPConfig(delta=-1)
    wpg = partition.partition_1d(GRAPHS["star"](generators), 2)
    with pytest.raises(ValueError, match="root"):
        sssp.distributed_sssp(wpg, wpg.n, device="cpu")
    assert sssp.SYNCS == ref_sssp.SYNCS and sssp.UNREACHED == ref_sssp.UNREACHED
    assert sssp.dist_rows(wpg) == ref_sssp.dist_rows(ref_part.partition_1d(
        GRAPHS["star"](ref_gen), 2))


def test_sssp_oracle_matches_reference_oracle():
    for name in ("kron", "star"):
        rg, tg = GRAPHS[name](ref_gen), GRAPHS[name](generators)
        root = _root(rg, 3)
        np.testing.assert_array_equal(sssp.sssp_reference(tg, root),
                                      ref_sssp.sssp_reference(rg, root))
    with pytest.raises(ValueError, match="weighted"):
        sssp.sssp_reference(generators.path_graph(8), 0)


def test_sssp_missing_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = partition.partition_1d(GRAPHS["star"](generators), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sssp.distributed_sssp(pg, 0)
