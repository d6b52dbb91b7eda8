"""PyTorch port, edge weights in the ETL: ``edge_weights``, the weighted
generators, ``from_edges``'s min-dedup and symmetry check, ``in_csr``'s
in-weights and the partition's ``edge_weight``/``in_weight`` equal the JAX
package's bit for bit (also carried through ``from_reference``), a
weighted graph has the unweighted graph's edge set, and ``place_arrays``
puts the weights on the device as int32 bit patterns."""

import numpy as np
import pytest
import torch

from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.core import bfs
from repro_torch.graph import csr, generators, partition

W = 16
# tests/test_traversal.py::GRAPHS, built by both packages from the same seeds
GRAPHS = {
    "kron": lambda gen: gen.kronecker(9, 8, seed=1, max_weight=W),
    "urand": lambda gen: gen.uniform_random(600, 3000, seed=2, max_weight=W),
    "torus": lambda gen: gen.torus_2d(16, max_weight=W, seed=3),
    "path": lambda gen: gen.path_graph(96, max_weight=W, seed=4),
    "star": lambda gen: gen.star_graph(64, max_weight=W, seed=5),
    "kron_directed": lambda gen: gen.kronecker(9, 8, seed=1, max_weight=W,
                                               symmetrize=False),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(ref_gen), make(generators)) for name, make in GRAPHS.items()}


@pytest.mark.parametrize("max_weight", [1, 7, 64, 2**32 - 1])
def test_edge_weights_match_reference(max_weight):
    rng = np.random.default_rng(max_weight % 97)
    src = rng.integers(0, 1 << 20, size=5000)
    dst = rng.integers(0, 1 << 20, size=5000)
    for seed in (0, 3):
        got = generators.edge_weights(src, dst, max_weight, seed)
        np.testing.assert_array_equal(got, ref_gen.edge_weights(src, dst, max_weight, seed))
        assert got.dtype == np.uint32 and got.min() >= 1 and got.max() <= max_weight
        np.testing.assert_array_equal(got, generators.edge_weights(dst, src, max_weight, seed))
    with pytest.raises(ValueError, match="max_weight"):
        generators.edge_weights(src, dst, 0)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_weighted_graph_matches_reference(graphs, name):
    rg, tg = graphs[name]
    assert tg.weighted and rg.weighted
    assert (tg.n, tg.n_real, tg.symmetric) == (rg.n, rg.n_real, rg.symmetric)
    for k in ("src", "dst", "row_offsets", "weights"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(rg, k), err_msg=k)
    for got, want in zip(csr.in_csr(tg), ref_csr.in_csr(rg)):
        np.testing.assert_array_equal(got, want)
    v = int(np.argmax(tg.out_degree))
    np.testing.assert_array_equal(tg.neighbor_weights(v), rg.neighbor_weights(v))


@pytest.mark.parametrize("name", ["kron", "urand", "torus"])
def test_weighted_and_unweighted_edge_sets_are_equal(name):
    """Weights are a pure function of the endpoints: the weighted graph has
    the unweighted one's edges, so every BFS path can run on it."""
    wg = GRAPHS[name](generators)
    ug = {"kron": lambda: generators.kronecker(9, 8, seed=1),
          "urand": lambda: generators.uniform_random(600, 3000, seed=2),
          "torus": lambda: generators.torus_2d(16, seed=3)}[name]()
    assert not ug.weighted
    for k in ("src", "dst", "row_offsets"):
        np.testing.assert_array_equal(getattr(wg, k), getattr(ug, k), err_msg=k)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_from_edges_min_dedup_matches_reference(symmetrize):
    """Raw weighted edges with duplicates of different weights and
    self-loops: symmetrize mirrors, dedup keeps the minimum (over the
    copies of both directions, so the result is symmetric)."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 40, size=400)
    dst = rng.integers(0, 40, size=400)
    w = rng.integers(1, 1000, size=400)
    want = ref_csr.from_edges(src, dst, 40, symmetrize=symmetrize, weights=w)
    got = csr.from_edges(src, dst, 40, symmetrize=symmetrize, weights=w)
    for k in ("src", "dst", "row_offsets", "weights"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def test_from_edges_symmetric_min_dedup_and_check():
    """The weight of both directions of a symmetrized edge is the minimum
    of every copy of either direction; weights that differ by direction
    fail validation, as the reference's do."""
    src = np.array([0, 1, 0, 2, 2, 3, 5])
    dst = np.array([1, 0, 1, 3, 3, 2, 5])
    w = np.array([9, 4, 7, 3, 8, 6, 1])
    want = ref_csr.from_edges(src, dst, 6, weights=w)
    got = csr.from_edges(src, dst, 6, weights=w)
    for k in ("src", "dst", "weights"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.weights.tolist() == [4, 4, 3, 3]
    bad = csr.Graph(n=32, n_real=4, src=got.src, dst=got.dst,
                    row_offsets=got.row_offsets,
                    weights=np.array([4, 5, 3, 3], dtype=np.uint32))
    with pytest.raises(csr.GraphValidationError, match="not symmetric"):
        bad.validate()
    with pytest.raises(ValueError, match="weights shape"):
        csr.from_edges(src, dst, 6, weights=w[:3])
    short = csr.Graph(n=32, n_real=4, src=got.src, dst=got.dst,
                      row_offsets=got.row_offsets, weights=got.weights[:3])
    with pytest.raises(csr.GraphValidationError, match="weights shape"):
        short.validate()


@pytest.mark.parametrize("name", ["kron", "torus", "star"])
@pytest.mark.parametrize("p", [1, 2, 8])
def test_partition_weights_match_reference(graphs, name, p):
    rg, tg = graphs[name]
    rpg, tpg = ref_part.partition_1d(rg, p), partition.partition_1d(tg, p)
    assert tpg.weighted and set(tpg.arrays()) == set(rpg.arrays())
    for k, v in rpg.arrays().items():
        np.testing.assert_array_equal(tpg.arrays()[k], v, err_msg=k)
    carried = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                       rpg.arrays())
    assert carried.edge_weight.dtype == np.uint32
    for k, v in rpg.arrays().items():
        np.testing.assert_array_equal(carried.arrays()[k], v, err_msg=k)


def test_partition_rejects_half_the_weights(graphs):
    rpg = ref_part.partition_1d(graphs["kron"][0], 2)
    arrays = dict(rpg.arrays())
    del arrays["in_weight"]
    with pytest.raises(ValueError, match="weights optional"):
        partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS}, arrays)
    unweighted = partition.partition_1d(generators.kronecker(9, 8, seed=1), 2)
    assert not unweighted.weighted and "edge_weight" not in unweighted.arrays()


def test_place_arrays_carries_weights_as_bit_patterns():
    g = generators.torus_2d(8, max_weight=2**32 - 1, seed=2)
    pg = partition.partition_1d(g, 2)
    arrays = bfs.place_arrays(pg, device="cpu")
    for k in ("edge_weight", "in_weight"):
        assert arrays[k].dtype == torch.int32
        np.testing.assert_array_equal(arrays[k].numpy().view(np.uint32), getattr(pg, k))
    assert int((arrays["edge_weight"] < 0).sum()) > 0  # bit 31 set on some weights
