"""PyTorch port, vertex programs: CC labels, k-core numbers and triangle
counts equal the JAX package's ``run_program`` and the host oracles bit for
bit, PageRank within the reference's ``PR_SLACK``, with the same rounds and
edges examined, on the families of ``tests/test_programs.py`` across
butterfly/sparse/adaptive x P in {1, 2, 8}; PageRank's sparse delta wire
equals the dense reduce bit for bit; the port's oracles equal the
reference's."""

import jax
import numpy as np
import pytest
import torch

from repro import programs as ref_programs
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch import programs
from repro_torch.graph import csr, generators, partition

SYNCS = ("butterfly", "sparse", "adaptive")
PR_TOL = 1e-5
PR_SLACK = 2 * PR_TOL * 0.85 / 0.15
GRAPHS = {
    "kron8": lambda gen: gen.kronecker(8, 8, seed=3),
    "torus16": lambda gen: gen.torus_2d(16),
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


_cache = {}


def _run(family, algo, sync, p, **kw):
    """Both packages' runs of one cell, once per module."""
    key = (family, algo, sync, p, tuple(sorted(kw.items())))
    if key not in _cache:
        g = GRAPHS[family](ref_gen)
        rpg = ref_part.partition_1d(g, p)
        want = ref_programs.run_program(
            rpg, _mesh(p), ref_programs.by_name(algo),
            ref_programs.ProgramConfig(sync=sync, tol=PR_TOL, **kw))
        got = programs.run_program(_port(rpg), programs.by_name(algo),
                                   programs.ProgramConfig(sync=sync, tol=PR_TOL, **kw),
                                   device="cpu")
        _cache[key] = (g, got, want)
    return _cache[key]


def _oracle(g, algo):
    return {"cc": ref_programs.cc_reference, "tri": ref_programs.triangles_reference,
            "kcore": ref_programs.kcore_reference}[algo](g)


def _check(family, algo, sync, p, **kw):
    g, got, want = _run(family, algo, sync, p, **kw)
    if algo == "pagerank":
        np.testing.assert_allclose(got[0], want[0], atol=PR_SLACK, rtol=0)
        ref = ref_programs.pagerank_reference(g, damping=0.85, tol=1e-12, max_iters=1000)
        np.testing.assert_allclose(got[0][: g.n], ref, atol=PR_SLACK, rtol=0)
        assert abs(got[0][: g.n].sum() - 1.0) < 1e-4
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0][: g.n], _oracle(g, algo))
    assert got[1:] == want[1:], (got[1:], want[1:])


@pytest.mark.parametrize("family", sorted(GRAPHS))
@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("algo", programs.PROGRAM_ALGOS)
def test_program_matches_reference_p8(family, algo, sync):
    _check(family, algo, sync, 8)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("algo", programs.PROGRAM_ALGOS)
def test_program_matches_reference_small_p(algo, sync, p):
    _check("kron8", algo, sync, p)


@pytest.mark.parametrize("sync", ["all_to_all", "xla"])
@pytest.mark.parametrize("algo", programs.PROGRAM_ALGOS)
def test_program_dense_baselines(algo, sync):
    _check("torus16", algo, sync, 8)


@pytest.mark.parametrize("family", sorted(GRAPHS))
@pytest.mark.parametrize("sync", ["sparse", "adaptive"])
def test_pagerank_delta_bit_identical_to_dense(family, sync):
    """Each rank ships its own ADD contribution against ``ref=None`` and
    every subcube partial arrives exactly once, so the float sums
    associate identically: the result is bit-equal to the dense reduce."""
    dense = _run(family, "pagerank", "butterfly", 8)[1][0]
    other = _run(family, "pagerank", sync, 8)[1][0]
    assert np.array_equal(dense.astype(np.float32).view(np.uint32),
                          other.astype(np.float32).view(np.uint32))


def test_pagerank_bit_identity_on_the_genuine_sparse_branch():
    """A near-empty graph under an explicit capacity keeps the sparse sync
    on its compacted wire format (no dense fallback)."""
    n = 1024
    src = np.array([1, 50, 200, 700, 900])
    dst = np.array([2, 51, 201, 701, 901])
    pg = partition.partition_1d(csr.from_edges(src, dst, n), 8)
    outs = {s: programs.run_program(pg, programs.by_name("pagerank"),
                                    programs.ProgramConfig(sync=s, sparse_capacity=256,
                                                           tol=PR_TOL), device="cpu")
            for s in ("butterfly", "sparse")}
    assert np.array_equal(outs["butterfly"][0].astype(np.float32).view(np.uint32),
                          outs["sparse"][0].astype(np.float32).view(np.uint32))
    rpg = ref_part.partition_1d(ref_csr.from_edges(src, dst, n), 8)
    want = ref_programs.run_program(rpg, _mesh(8), ref_programs.by_name("pagerank"),
                                    ref_programs.ProgramConfig(sync="sparse",
                                                               sparse_capacity=256,
                                                               tol=PR_TOL))
    np.testing.assert_allclose(outs["sparse"][0], want[0], atol=PR_SLACK, rtol=0)
    assert outs["sparse"][1:] == want[1:]


def test_triangle_total_and_refusal():
    g, got, _ = _run("kron8", "tri", "butterfly", 8)
    assert programs.total_triangles(got[0]) == ref_programs.total_triangles(
        ref_programs.triangles_reference(g))
    big = partition.partition_1d(generators.path_graph(46400), 2)
    with pytest.raises(ValueError, match="n_rows\\^2 bits addressable by int32"):
        programs.program_msg_words(big, programs.by_name("tri"))
    assert programs.triangles.MAX_ROWS == ref_programs.triangles.MAX_ROWS


@pytest.mark.parametrize("family", ["kron8", "torus16", "urand", "directed"])
def test_oracles_match_reference_oracles(family):
    make = {**GRAPHS,
            "urand": lambda gen: gen.uniform_random(300, 2000, seed=4),
            "directed": lambda gen: gen.kronecker(7, 8, seed=5, symmetrize=False)}[family]
    rg, tg = make(ref_gen), make(generators)
    for name in ("cc_reference", "kcore_reference", "triangles_reference"):
        np.testing.assert_array_equal(getattr(programs, name)(tg),
                                      getattr(ref_programs, name)(rg), err_msg=name)
    np.testing.assert_array_equal(programs.pagerank_reference(tg),
                                  ref_programs.pagerank_reference(rg))


def test_registry_and_config_match_reference():
    assert programs.PROGRAM_ALGOS == ref_programs.PROGRAM_ALGOS
    assert programs.SYNCS == ref_programs.SYNCS
    for name in programs.PROGRAM_ALGOS:
        p, r = programs.by_name(name), ref_programs.by_name(name)
        assert (p.monoid.name, p.monoid.sparse_mode) == (r.monoid.name, r.monoid.sparse_mode)
    with pytest.raises(ValueError, match="unknown vertex program"):
        programs.by_name("louvain")
    with pytest.raises(ValueError, match="unknown program sync"):
        programs.ProgramConfig(sync="rabenseifner")
    with pytest.raises(ValueError, match="damping"):
        programs.ProgramConfig(damping=1.0)
    with pytest.raises(ValueError, match="tol"):
        programs.ProgramConfig(tol=0)
    pg = partition.partition_1d(GRAPHS["kron8"](generators), 4)
    rpg = ref_part.partition_1d(GRAPHS["kron8"](ref_gen), 4)
    assert programs.program_rows(pg) == ref_programs.program_rows(rpg)
    for name in programs.PROGRAM_ALGOS:
        assert programs.program_msg_words(pg, programs.by_name(name)) == \
            ref_programs.program_msg_words(rpg, ref_programs.by_name(name))


def test_pagerank_warm_start_from_cached_ranks():
    """``rank_arg`` lifts a result back into the operand: restarting from
    the fixed point converges in one round to the same ranks."""
    pg = partition.partition_1d(GRAPHS["kron8"](generators), 4)
    prog = programs.by_name("pagerank")
    cold, iters, _ = programs.run_program(pg, prog, device="cpu")
    warm, witers, _ = programs.run_program(pg, prog, arg=programs.rank_arg(pg, cold, device="cpu"),
                                           device="cpu")
    assert witers < iters
    np.testing.assert_allclose(warm, cold, atol=PR_SLACK, rtol=0)


def test_or_programs_merge_through_the_kernel_wrapper(monkeypatch):
    """k-core's peel waves and the triangle adjacency merge through
    ``bitmap_or_reduce`` (the kernel on the card), one call a round of
    every dense sync; PageRank and CC merge in plain PyTorch."""
    from repro_torch.core import collectives
    from repro_torch.kernels import bitmap_merge

    calls = []
    real = bitmap_merge.bitmap_or_reduce
    monkeypatch.setattr(bitmap_merge, "bitmap_or_reduce",
                        lambda stack: calls.append(stack.shape) or real(stack))
    pg = partition.partition_1d(GRAPHS["kron8"](generators), 8)
    depth = len(collectives.Communicator(8, "cpu").schedule(4).rounds)
    cfg = programs.ProgramConfig(fanout=4)
    for algo in programs.PROGRAM_ALGOS:
        calls.clear()
        _, iters, _ = programs.run_program(pg, programs.by_name(algo), cfg, device="cpu")
        want = iters * depth if programs.by_name(algo).monoid.name == "or" else 0
        assert len(calls) == want, algo
    assert calls[0] == (8, 4, programs.program_msg_words(pg, programs.by_name("kcore")))


def test_programs_missing_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = partition.partition_1d(GRAPHS["kron8"](generators), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        programs.run_program(pg, programs.by_name("cc"))
