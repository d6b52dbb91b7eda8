"""PyTorch port, Brandes betweenness centrality: scores equal the JAX
package's ``betweenness_centrality`` and host Brandes within the
reference's own ``rtol=atol=1e-4``, with the same wave depth and edges
examined, on every family of ``tests/test_traversal.py`` and across
butterfly/sparse/adaptive x P in {1, 2, 8}; each lane's levels equal the
single-source BFS and its dependencies satisfy Brandes' identity."""

import jax
import numpy as np
import pytest
import torch

from repro.core import bfs as ref_bfs
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.traversal import bc as ref_bc
from repro_torch.core import bfs
from repro_torch.graph import generators, partition
from repro_torch.traversal import bc

W = 16
GRAPHS = {
    "kron": lambda gen: gen.kronecker(9, 8, seed=1, max_weight=W),
    "urand": lambda gen: gen.uniform_random(600, 3000, seed=2, max_weight=W),
    "torus": lambda gen: gen.torus_2d(16, max_weight=W, seed=3),
    "path": lambda gen: gen.path_graph(96, max_weight=W, seed=4),
    "star": lambda gen: gen.star_graph(64, max_weight=W, seed=5),
}


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


def _sources(g, k, seed=7):
    rng = np.random.default_rng(seed)
    return np.array([ref_csr.largest_component_root(g, rng) for _ in range(k)], np.int32)


def _check(name, p, n_sources=5, **kw):
    g = _graph(name)
    rpg = ref_part.partition_1d(g, p)
    sources = _sources(g, n_sources)
    want = ref_bc.betweenness_centrality(rpg, _mesh(p), sources,
                                         ref_bfs.BFSConfig(axes=("data",), fanout=4, **kw))
    got = bc.betweenness_centrality(_port(rpg), sources, bfs.BFSConfig(fanout=4, **kw),
                                    device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4,
                               err_msg=f"{name} P={p} {kw}")
    np.testing.assert_allclose(got[0], ref_bc.bc_reference(g, sources), rtol=1e-4,
                               atol=1e-4)
    assert got[1:] == want[1:], (got[1:], want[1:])
    return got


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bc_matches_reference_per_family(name):
    _check(name, 8, sync="adaptive")


@pytest.mark.parametrize("sync", ["butterfly", "sparse", "adaptive"])
@pytest.mark.parametrize("p", [1, 2, 8])
def test_bc_sync_by_partition_count(sync, p):
    _check("kron", p, sync=sync)


@pytest.mark.parametrize("sync", ["rabenseifner", "all_to_all", "xla"])
def test_bc_dense_syncs(sync):
    """The ADD merges of the dense families (Rabenseifner's reduce-scatter
    on float32, the all-to-all ring, the all-gather sum)."""
    _check("torus", 8, sync=sync)


def test_bc_duplicate_and_inactive_lanes():
    g = _graph("kron")
    rpg = ref_part.partition_1d(g, 4)
    s = _sources(g, 2)
    lanes = np.array([s[0], -1, s[0], s[1]], np.int32)
    want = ref_bc.betweenness_centrality(rpg, _mesh(4), lanes, ref_bfs.BFSConfig(fanout=4))
    got = bc.betweenness_centrality(_port(rpg), lanes, bfs.BFSConfig(fanout=4),
                                    device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], ref_bc.bc_reference(g, [s[0], s[0], s[1]]),
                               rtol=1e-4, atol=1e-4)
    assert got[1:] == want[1:]


def test_bc_lanes_levels_and_brandes_identity():
    """Each lane's levels equal the single-source BFS distances at its
    root, and sum_v delta_s(v) = sum_{t reached, t != s} (d(s, t) - 1)
    (every shortest s-t path has d - 1 interior vertices)."""
    g = GRAPHS["kron"](generators)
    pg = partition.partition_1d(g, 4)
    assert len(set(pg.v_count.tolist())) > 1  # windows overlap the next rank's rows
    roots = [int(r) for r in _sources(g, 3)]
    arrays = bfs.place_arrays(pg, device="cpu")
    out = {}
    fn = bc.build_bc_fn(pg, bfs.BFSConfig(fanout=4), len(roots), device="cpu")
    fn(arrays, roots, lanes=out)
    single = bfs.build_bfs_fn(pg, bfs.BFSConfig(fanout=4), device="cpu")
    for b, r in enumerate(roots):
        d_owned = single(arrays, r)[0]
        assert torch.equal(out["levels"][..., b], d_owned)
        d = bfs.assemble_distances(pg, d_owned)
        reached = (d < bfs.INF) & (d > 0)
        np.testing.assert_allclose(float(out["delta"][..., b].double().sum()),
                                   float((d[reached] - 1).sum()), rtol=1e-4)


def test_bc_refuses_what_the_reference_refuses():
    pg = partition.partition_1d(GRAPHS["kron"](generators), 2)
    with pytest.raises(NotImplementedError, match="top_down"):
        bc.build_bc_fn(pg, bfs.BFSConfig(mode="direction_optimizing"), 4, device="cpu")
    with pytest.raises(NotImplementedError, match="single-source"):
        bc.build_bc_fn(pg, bfs.BFSConfig(use_kernels=True), 4, device="cpu")
    with pytest.raises(ValueError, match="n_lanes"):
        bc.build_bc_fn(pg, bfs.BFSConfig(), 0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        bc.betweenness_centrality(pg, [pg.n], device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        bc.betweenness_centrality(pg, [], device="cpu")
    with pytest.raises(ValueError, match="roots"):
        bc.build_bc_fn(pg, bfs.BFSConfig(), 3, device="cpu")(
            bfs.place_arrays(pg, device="cpu"), [1, 2])


def test_bc_oracle_matches_reference_oracle():
    rg, tg = _graph("urand"), GRAPHS["urand"](generators)
    s = _sources(rg, 3)
    np.testing.assert_array_equal(bc.bc_reference(tg, s), ref_bc.bc_reference(rg, s))


def test_bc_forward_merges_go_through_the_kernel_wrapper(monkeypatch):
    """The forward wave's dense OR rounds call ``bitmap_or_reduce`` (the
    kernel on the card): one per butterfly round a level."""
    from repro_torch.core import collectives
    from repro_torch.kernels import bitmap_merge

    calls = []
    real = bitmap_merge.bitmap_or_reduce
    monkeypatch.setattr(bitmap_merge, "bitmap_or_reduce",
                        lambda stack: calls.append(stack.shape) or real(stack))
    pg = partition.partition_1d(GRAPHS["kron"](generators), 8)
    _, depth, _ = bc.betweenness_centrality(pg, [3, 5], bfs.BFSConfig(fanout=4),
                                            device="cpu")
    assert len(calls) == depth * len(collectives.Communicator(8, "cpu").schedule(4).rounds)


def test_bc_missing_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = partition.partition_1d(GRAPHS["star"](generators), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bc.betweenness_centrality(pg, [0])
