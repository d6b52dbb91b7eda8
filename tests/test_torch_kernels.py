"""PyTorch port, kernels: on CPU tensors each wrapper takes its plain
version, which equals the JAX package's Pallas kernel (interpret mode)
over the shape sweeps of tests/test_kernels.py, rank by rank.  The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py."""

import ctypes
import os
import re
import stat
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.kernels import blocks as ref_blocks
from repro.kernels import ops as ref_ops
from repro_torch.core import frontier as fr
from repro_torch.graph import partition
from repro_torch.kernels import bitmap_merge, blocks, build, frontier_gather
from repro_torch.kernels import frontier_scatter, ops

P = 2  # ranks stacked per call


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u32(t):
    return t.view(torch.uint32).numpy() if t.dtype == torch.int32 else t.numpy()


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


# --- bitmap OR-reduce --------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("w", [128, 1024, 4096])
def test_bitmap_or_reduce_matches_pallas(k, w):
    rng = np.random.default_rng(k * w)
    stack = _words(rng, P, k, w)
    got = _u32(bitmap_merge.bitmap_or_reduce(_t(stack)))
    for r in range(P):
        want = ref_ops.bitmap_or_reduce(jnp.asarray(stack[r]))
        np.testing.assert_array_equal(got[r], np.asarray(want), err_msg=f"rank {r}")


# --- frontier gather ---------------------------------------------------------


@pytest.mark.parametrize("nb,eb,ww", [(4, 128, 8), (7, 256, 16), (2, 512, 64)])
def test_frontier_gather_windowed_matches_pallas(nb, eb, ww):
    rng = np.random.default_rng(nb)
    w = ww * 8
    words = _words(rng, P, w)
    block_ws = rng.integers(0, w // ww, size=(P, nb)).astype(np.int32)
    src_local = rng.integers(0, ww * 32, size=(P, nb, eb)).astype(np.int32)
    got = frontier_gather.frontier_gather(_t(words), _t(block_ws), _t(src_local), ww=ww)
    assert got.dtype == torch.bool
    for r in range(P):
        want = ref_ops.frontier_gather(jnp.asarray(words[r]), jnp.asarray(block_ws[r]),
                                       jnp.asarray(src_local[r]), ww=ww)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,eb", [(3, 128), (6, 512)])
def test_frontier_gather_full_matches_pallas(nb, eb):
    rng = np.random.default_rng(nb)
    w = 256
    words = _words(rng, P, w)
    src = rng.integers(0, w * 32, size=(P, nb, eb)).astype(np.int32)
    got = frontier_gather.frontier_gather_full(_t(words), _t(src))
    for r in range(P):
        want = ref_ops.frontier_gather_full(jnp.asarray(words[r]), jnp.asarray(src[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


# --- full gather: the planner, and parity at the kernels' edge inputs ---------


@pytest.mark.parametrize("ids_sorted,route", [(True, "walk"), (False, "probe")])
def test_plan_gather_full_follows_the_ids_order(ids_sorted, route):
    """Sorted ids take the walk (4 slots a lane), random ids the probe (one
    slot a lane): the planner takes the order, not the shape, since the
    three Kronecker sites have one shape."""
    assert frontier_gather.plan_gather_full(ids_sorted) == route


@pytest.fixture(scope="module")
def sparse_full():
    """A graph so sparse that 512 sorted ids span more than the widest
    window, so both gathers of its layout are full, as at Kronecker scale
    18 and over."""
    from repro_torch.graph import generators

    pg = partition.partition_1d(generators.uniform_random(1 << 18, 3000, seed=1), 2)
    lay = blocks.build_bfs_layout(pg)
    assert lay.meta["gather_full"] and lay.meta["pull_gather_full"]
    return pg, lay


@pytest.mark.parametrize("plane,ordered", [("tdg_src", True), ("pug_dst", True),
                                           ("in_src_blocks", False)])
def test_layout_records_which_planes_hold_sorted_ids(sparse_full, plane, ordered):
    """The layout builder says which full-gather planes hold each rank's
    ids in ascending order, and they do; in-edge sources are not sorted."""
    pg, lay = sparse_full
    assert (plane in lay.meta["sorted_planes"]) is ordered
    count = pg.edge_count if plane == "tdg_src" else pg.in_count
    for r in range(pg.p):
        ids = lay.arrays[plane][r].reshape(-1)[: int(count[r])]
        assert bool(np.all(np.diff(ids) >= 0)) is ordered, r


@pytest.mark.parametrize("direction", ["push", "pull"])
def test_expansion_ops_give_the_full_gather_each_planes_order(sparse_full, monkeypatch,
                                                              direction):
    """``expand_push`` and ``expand_pull`` pass the layout's order of the
    plane they gather over, so each site takes the route for its ids."""
    pg, lay = sparse_full
    arrays = {k: torch.from_numpy(v) for k, v in pg.arrays().items()}
    arrays.update({k: torch.from_numpy(v) for k, v in lay.arrays.items()})
    for k in ("tds_perm", "pus_perm"):
        arrays[k] = arrays[k].long()
    seen = {}
    real = ops.frontier_gather_full

    def spy(words, src, *, ids_sorted):
        seen[next(k for k, v in arrays.items() if v is src)] = ids_sorted
        return real(words, src, ids_sorted=ids_sorted)

    monkeypatch.setattr(ops, "frontier_gather_full", spy)
    front = fr.pack(torch.zeros(pg.p, pg.n_words * 32, dtype=torch.bool))
    if direction == "push":
        ops.expand_push(front, arrays, lay.meta, pg.n_words)
        assert seen == {"tdg_src": True}
    else:
        ops.expand_pull(front, front, arrays, lay.meta, pg.n_words)
        assert seen == {"in_src_blocks": False, "pug_dst": True}


@pytest.mark.parametrize("ids_sorted", [False, True])
@pytest.mark.parametrize("nb,eb,w", [(3, 200, 256), (1, 200, 1001), (2, 512, 64),
                                     (4, 128, 1024)])
def test_frontier_gather_full_matches_pallas_at_edge_inputs(nb, eb, w, ids_sorted):
    """eb not a multiple of 16 (the kernels' narrow path), a bitmap not a
    multiple of 4 words, a hub block on bit 31 of the last word (the first
    block for random ids, the last for sorted ids, which keeps them
    sorted), and the last slot of every rank on it."""
    rng = np.random.default_rng(eb + w)
    words = _words(rng, P, w)
    words[0, -1] |= np.uint32(1 << 31)
    words[1, -1] &= np.uint32(0x7FFFFFFF)
    src = rng.integers(0, w * 32, size=(P, nb, eb)).astype(np.int32)
    hub = -1 if ids_sorted else 0
    if ids_sorted:
        src = np.sort(src.reshape(P, -1), axis=1).reshape(P, nb, eb)
    src[:, hub] = w * 32 - 1
    src[:, -1, -1] = w * 32 - 1
    if ids_sorted:
        assert np.all(np.diff(src.reshape(P, -1), axis=1) >= 0)
    got = frontier_gather.frontier_gather_full(_t(words), _t(src), ids_sorted=ids_sorted)
    assert got[0, hub].all() and not got[1, hub].any()
    for r in range(P):
        want = ref_ops.frontier_gather_full(jnp.asarray(words[r]), jnp.asarray(src[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want), err_msg=f"rank {r}")


# --- frontier scatter --------------------------------------------------------


@pytest.mark.parametrize("n_windows,ww,nb,eb", [(4, 8, 6, 128), (2, 64, 3, 512),
                                                (6, 8, 3, 128)])
def test_frontier_scatter_matches_pallas(n_windows, ww, nb, eb):
    rng = np.random.default_rng(nb * ww)
    bits = ww * 32
    block_win = np.sort(rng.integers(0, n_windows, size=(P, nb)), axis=1).astype(np.int32)
    block_first = np.zeros((P, nb), np.int32)
    for r in range(P):
        _, first = np.unique(block_win[r], return_index=True)
        block_first[r, first] = 1
    dst_local = rng.integers(0, bits + 1, size=(P, nb, eb)).astype(np.int32)
    active = rng.integers(0, 2, size=(P, nb, eb)).astype(bool)
    got = _u32(frontier_scatter.frontier_scatter(
        _t(active), _t(block_win), _t(dst_local), n_windows=n_windows, ww=ww))
    for r in range(P):
        want = np.asarray(ref_ops.frontier_scatter(
            jnp.asarray(active[r]), jnp.asarray(block_win[r]), jnp.asarray(block_first[r]),
            jnp.asarray(dst_local[r]), n_windows=n_windows, ww=ww)).reshape(n_windows, ww)
        g = got[r].reshape(n_windows, ww)
        covered = np.zeros(n_windows, bool)
        covered[block_win[r]] = True
        # the Pallas kernel leaves uncovered windows undefined; the port zeroes them
        np.testing.assert_array_equal(g[covered], want[covered])
        assert not g[~covered].any()


# --- edge shapes of the warp-per-block kernels ------------------------------
# eb not a multiple of 16 (the kernels' scalar path), one block, the widest
# windows, hub blocks (every slot on bit 31 of the window's last word)


def _hub_first_block(x, bits):
    x[:, 0] = bits - 1
    return x


@pytest.mark.parametrize("nb,eb,ww", [(1, 200, 8), (3, 200, 64), (2, 512, 32),
                                      (1, 128, 4096)])
def test_frontier_gather_windowed_matches_pallas_at_edge_shapes(nb, eb, ww):
    rng = np.random.default_rng(eb + ww)
    w = ww * 2
    words = _words(rng, P, w)
    block_ws = rng.integers(0, w // ww, size=(P, nb)).astype(np.int32)
    src_local = _hub_first_block(
        rng.integers(0, ww * 32, size=(P, nb, eb)).astype(np.int32), ww * 32)
    got = frontier_gather.frontier_gather(_t(words), _t(block_ws), _t(src_local), ww=ww)
    for r in range(P):
        want = ref_ops.frontier_gather(jnp.asarray(words[r]), jnp.asarray(block_ws[r]),
                                       jnp.asarray(src_local[r]), ww=ww)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("n_windows,ww,nb,eb,density", [
    (3, 8, 1, 200, 1.0), (5, 8, 4, 200, 0.02), (2, 64, 5, 512, 0.0),
    (4, 8, 7, 128, 1.0)])
def test_frontier_scatter_matches_pallas_at_edge_shapes(n_windows, ww, nb, eb, density):
    rng = np.random.default_rng(nb * eb)
    bits = ww * 32
    block_win = np.sort(rng.integers(0, n_windows, size=(P, nb)), axis=1).astype(np.int32)
    block_first = np.zeros((P, nb), np.int32)
    for r in range(P):
        _, first = np.unique(block_win[r], return_index=True)
        block_first[r, first] = 1
    # sorted by destination, padding (== bits) at each block's tail
    dst_local = np.sort(rng.integers(0, bits + 1, size=(P, nb, eb)), axis=-1).astype(np.int32)
    dst_local = _hub_first_block(dst_local, bits)
    active = rng.random((P, nb, eb)) < density
    active[:, 0] = True
    got = _u32(frontier_scatter.frontier_scatter(
        _t(active), _t(block_win), _t(dst_local), n_windows=n_windows, ww=ww))
    for r in range(P):
        want = np.asarray(ref_ops.frontier_scatter(
            jnp.asarray(active[r]), jnp.asarray(block_win[r]), jnp.asarray(block_first[r]),
            jnp.asarray(dst_local[r]), n_windows=n_windows, ww=ww)).reshape(n_windows, ww)
        g = got[r].reshape(n_windows, ww)
        covered = np.zeros(n_windows, bool)
        covered[block_win[r]] = True
        np.testing.assert_array_equal(g[covered], want[covered])
        assert not g[~covered].any()
        assert g[block_win[r, 0], ww - 1] >> 31 == 1  # the hub's bit


# --- BFS-facing expansion ----------------------------------------------------


@pytest.fixture(scope="module")
def kron9():
    out = {}
    for p in (1, 2):
        rpg = ref_part.partition_1d(ref_gen.kronecker(9, 6, seed=5), p)
        rlay = ref_blocks.build_bfs_layout(rpg)
        tpg = partition.from_reference(
            {k: getattr(rpg, k) for k in partition.SCALARS}, rpg.arrays())
        tlay = blocks.build_bfs_layout(tpg)
        out[p] = (rpg, rlay, tpg, tlay)
    return out


def _ref_arrays(rpg, rlay, r):
    arrays = {k: jnp.asarray(v[r]) for k, v in rpg.arrays().items()}
    arrays.update({k: jnp.asarray(v[r]) for k, v in rlay.arrays.items()})
    return arrays


def _port_arrays(tpg, tlay):
    arrays = {k: torch.from_numpy(v) for k, v in tpg.arrays().items()}
    arrays.update({k: torch.from_numpy(v) for k, v in tlay.arrays.items()})
    for k in ("tds_perm", "pus_perm"):
        arrays[k] = arrays[k].long()
    return arrays


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("density", [0.05, 0.5])
def test_expand_push_matches_pallas(kron9, p, density):
    rpg, rlay, tpg, tlay = kron9[p]
    rng = np.random.default_rng(p)
    front = fr.pack(torch.from_numpy(rng.random((p, tpg.n_words * 32)) < density))
    got = _u32(ops.expand_push(front, _port_arrays(tpg, tlay), tlay.meta, tpg.n_words))
    for r in range(p):
        want = ref_ops.expand_push_pallas(jnp.asarray(_u32(front)[r]),
                                          _ref_arrays(rpg, rlay, r), rlay.meta, rpg.n_words)
        np.testing.assert_array_equal(got[r], np.asarray(want), err_msg=f"rank {r}")


@pytest.mark.parametrize("p", [1, 2])
def test_expand_pull_matches_pallas(kron9, p):
    rpg, rlay, tpg, tlay = kron9[p]
    rng = np.random.default_rng(10 + p)
    front = fr.pack(torch.from_numpy(rng.random((p, tpg.n_words * 32)) < 0.1))
    visited = front | fr.pack(torch.from_numpy(rng.random((p, tpg.n_words * 32)) < 0.3))
    got = _u32(ops.expand_pull(front, visited, _port_arrays(tpg, tlay), tlay.meta,
                               tpg.n_words))
    for r in range(p):
        want = ref_ops.expand_pull_pallas(
            jnp.asarray(_u32(front)[r]), jnp.asarray(_u32(visited)[r]),
            _ref_arrays(rpg, rlay, r), rlay.meta, rpg.n_words)
        np.testing.assert_array_equal(got[r], np.asarray(want), err_msg=f"rank {r}")


# --- wrapper contracts -------------------------------------------------------


def test_wrappers_check_dtype_shape_and_contiguity():
    words = torch.zeros(2, 64, dtype=torch.int32)
    src = torch.zeros(2, 3, 128, dtype=torch.int32)
    with pytest.raises(TypeError):
        frontier_gather.frontier_gather_full(words.long(), src)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_gather.frontier_gather_full(words[:, ::2], src)
    with pytest.raises(ValueError, match="ranks"):
        frontier_gather.frontier_gather_full(words, src[:1])
    with pytest.raises(ValueError, match="multiple"):
        frontier_gather.frontier_gather(words, torch.zeros(2, 3, dtype=torch.int32),
                                        src, ww=48)
    with pytest.raises(ValueError, match="disagree"):
        frontier_scatter.frontier_scatter(torch.zeros(2, 3, 128, dtype=torch.bool),
                                          torch.zeros(2, 4, dtype=torch.int32), src,
                                          n_windows=2, ww=8)
    with pytest.raises(ValueError, match="rank"):
        bitmap_merge.bitmap_or_reduce(words)


def test_wrappers_route_by_device_and_count_only_launches():
    build.reset_launches()
    out = bitmap_merge.bitmap_or_reduce(torch.ones(1, 2, 4, dtype=torch.int32))
    assert out.tolist() == [[1, 1, 1, 1]]
    assert build.LAUNCHES["bitmap_or_reduce"] == 0  # the plain path launched nothing
    with pytest.raises(ValueError, match="no kernel"):
        bitmap_merge.bitmap_or_reduce(torch.ones(1, 2, 4, dtype=torch.int32, device="meta"))


def test_windowed_gather_rejects_a_window_over_the_widest():
    ww = frontier_gather.MAX_WINDOW_WORDS * 2
    words = torch.zeros(1, ww, dtype=torch.int32)
    with pytest.raises(ValueError, match="over"):
        frontier_gather.frontier_gather(words, torch.zeros(1, 1, dtype=torch.int32),
                                        torch.zeros(1, 1, 16, dtype=torch.int32), ww=ww)


@pytest.mark.parametrize("eb,offset,want", [
    (512, 0, True), (128, 0, True), (200, 0, False), (8, 0, False),
    (512, 1, False), (512, 4, False), (512, 16, True)])
def test_vectorizable_needs_eb_in_sixteens_and_aligned_tensors(eb, offset, want):
    aligned = torch.zeros(64, dtype=torch.int32)
    buf = torch.zeros(4096, dtype=torch.uint8)
    base = (-buf.data_ptr()) % 16  # first 16-byte boundary in buf
    view = buf[base + offset:base + offset + 1024]
    assert aligned.data_ptr() % 16 == 0
    assert build.vectorizable(eb, aligned, view) is want
    assert build.vectorizable(eb, aligned) is (eb % 16 == 0)


def test_c_entry_points_take_the_bound_arguments():
    """Each ``repro_<name>`` in csrc takes what ``build.SIGNATURES`` binds
    (a pointer for ``c_void_p``, ``long long`` for ``c_longlong``), then the
    stream: a mismatch would pass garbage through ctypes on the card."""
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int repro_(\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = ["p" if "*" in a else "i" for a in params.split(",")]
    for name, args in build.SIGNATURES.items():
        want = ["p" if a is ctypes.c_void_p else "i" for a in args] + ["p"]
        assert found[name] == want, name


def test_gather_full_entry_point_takes_the_walk_and_vec_flags():
    """The full gather's C entry point takes a rank's slot count, whether
    to walk (sorted ids) or probe, and the 16-byte flag the wrapper
    passes."""
    src = (build.CSRC / "frontier_gather.cu").read_text()
    params = re.search(r'extern "C" int repro_frontier_gather_full\(([^)]*)\)', src)
    names = [a.split()[-1].lstrip("*") for a in params.group(1).split(",")]
    assert names == ["words", "src", "out", "p", "n_words", "slots", "walk", "vec",
                     "stream"]
    assert "walk == 0: the probe (random ids), else the walk (sorted ids)" in src


# --- build -------------------------------------------------------------------

_FAKE_NVCC = """\
#!{python}
import sys
args = sys.argv[1:]
if any(a.endswith("bad.cu") for a in args):
    print("bad.cu(1): error: expected a declaration"); sys.exit(1)
open(args[args.index("-o") + 1], "w").write("object")
print("ptxas info    : Used 8 registers")
"""


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(_FAKE_NVCC.format(python=sys.executable)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    return csrc


def test_build_keys_library_on_source_hash(fake_toolchain):
    lib = build.build()
    assert lib.exists() and lib.parent.parent == build.BUILD_ROOT
    assert "registers" in (lib.parent / "build.log").read_text()
    assert build.build() == lib  # cached
    (fake_toolchain / "a.cu").write_text("// a, edited\n")
    assert build.build() != lib


def test_failed_build_raises(fake_toolchain):
    (fake_toolchain / "bad.cu").write_text("oops\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        build.build()
    assert not list(build.BUILD_ROOT.rglob(build.LIB_NAME))


def test_kernel_sources_carry_their_notes():
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        assert "Replaces the TPU kernel" in text, src.name
        assert "What bounds it on the H100" in text, src.name
        assert "What the design does about it" in text, src.name
    entry_points = {n for src in build.CSRC.glob("*.cu")
                    for n in build.SIGNATURES if f"repro_{n}(" in src.read_text()}
    assert entry_points == set(build.SIGNATURES)


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setenv("PATH", os.devnull)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
