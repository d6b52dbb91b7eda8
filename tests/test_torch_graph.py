"""PyTorch port, host ETL: graphs, partitions and kernel layouts equal the
JAX package's bit for bit, and the port imports nothing of it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.kernels import blocks as ref_blocks
from repro_torch.graph import csr, generators, partition
from repro_torch.kernels import blocks

# tests/test_bfs.py::GRAPHS, built by both packages from the same seeds
GRAPHS = {
    "kron10": lambda gen: gen.kronecker(10, 8, seed=1),
    "urand": lambda gen: gen.uniform_random(600, 3000, seed=2),
    "torus": lambda gen: gen.torus_2d(20),
    "path": lambda gen: gen.path_graph(200),
    "star": lambda gen: gen.star_graph(500),
}
PS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(ref_gen), make(generators)) for name, make in GRAPHS.items()}


@pytest.fixture(scope="module")
def partitions(graphs):
    return {
        (name, p): (ref_part.partition_1d(rg, p), partition.partition_1d(tg, p))
        for name, (rg, tg) in graphs.items() for p in PS
    }


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_matches_reference(graphs, name):
    rg, tg = graphs[name]
    assert (tg.n, tg.n_real, tg.symmetric) == (rg.n, rg.n_real, rg.symmetric)
    for k in ("src", "dst", "row_offsets"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(rg, k), err_msg=k)
    for got, want in zip(csr.in_csr(tg), ref_csr.in_csr(rg)[:3]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_components_and_roots_match_reference(graphs, name):
    rg, tg = graphs[name]
    np.testing.assert_array_equal(csr.connected_components(tg),
                                  ref_csr.connected_components(rg))
    np.testing.assert_array_equal(
        csr.largest_component_roots(tg, 5, np.random.default_rng(7)),
        ref_csr.largest_component_roots(rg, 5, np.random.default_rng(7)))


def test_components_on_disjoint_pieces():
    src = np.array([0, 5, 9, 40, 41])
    dst = np.array([3, 9, 3, 41, 60])
    tg, rg = csr.from_edges(src, dst, 70), ref_csr.from_edges(src, dst, 70)
    labels = csr.connected_components(tg)
    np.testing.assert_array_equal(labels, ref_csr.connected_components(rg))
    assert labels[0] == labels[3] == labels[5] == labels[9]
    assert labels[40] == labels[41] == labels[60] != labels[0]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_partition_matches_reference(partitions, name, p):
    rpg, tpg = partitions[name, p]
    assert tpg.scalars() == {k: getattr(rpg, k) for k in partition.SCALARS}
    ref_arrays = rpg.arrays()
    assert set(tpg.arrays()) == set(ref_arrays)
    for k, v in tpg.arrays().items():
        assert v.dtype == ref_arrays[k].dtype, k
        np.testing.assert_array_equal(v, ref_arrays[k], err_msg=k)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_layout_matches_reference(partitions, name, p):
    rpg, tpg = partitions[name, p]
    want = ref_blocks.build_bfs_layout(rpg)
    got = blocks.build_bfs_layout(tpg)
    # the port's meta adds which planes hold sorted ids (its full gather's
    # route follows them)
    assert {k: v for k, v in got.meta.items() if k != "sorted_planes"} == want.meta
    assert got.meta["sorted_planes"] == ("tdg_src", "pug_dst")
    assert set(got.arrays) == set(want.arrays)
    for k, v in got.arrays.items():
        assert v.dtype == want.arrays[k].dtype, k
        np.testing.assert_array_equal(v, want.arrays[k], err_msg=k)


@pytest.mark.parametrize("name", ["kron10", "star"])
def test_from_reference_round_trips(partitions, name):
    rpg, tpg = partitions[name, 4]
    scalars = {k: getattr(rpg, k) for k in partition.SCALARS}
    carried = partition.from_reference(scalars, rpg.arrays())
    again = partition.from_reference(tpg.scalars(), tpg.arrays())
    for pg in (carried, again):
        assert pg.scalars() == tpg.scalars()
        for k, v in tpg.arrays().items():
            np.testing.assert_array_equal(pg.arrays()[k], v, err_msg=k)
    assert not np.shares_memory(carried.edge_src, rpg.edge_src)  # a copy


def test_from_reference_rejects_wrong_keys(partitions):
    rpg, tpg = partitions["kron10", 2]
    with pytest.raises(ValueError, match="scalars"):
        partition.from_reference({"p": 2}, rpg.arrays())
    arrays = dict(rpg.arrays(), edge_weight=np.zeros((2, rpg.emax), np.uint32))
    with pytest.raises(ValueError, match="arrays"):
        partition.from_reference(tpg.scalars(), arrays)


def test_etl_rejects_corrupt_graph():
    g = generators.path_graph(40)
    g.dst = g.dst.copy()
    g.dst[0] = g.src[0]  # a self-loop
    g._validated = False
    with pytest.raises(csr.GraphValidationError):
        partition.partition_1d(g, 2)


_ISOLATED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None   # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None), "port pulled in jax/repro"
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", _ISOLATED_IMPORT], cwd=src,
                         env=dict(os.environ, PYTHONPATH=src), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module of the port imported
