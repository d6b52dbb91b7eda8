"""chip_smoke.py's pure helpers on the CPU: the least-bytes models behind
the kernels' bounds, the split of launch counts into call sites, and the
edge-case inputs.  Tiny hand-made tensors; no card is touched."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402


# --- distinct_word_bytes -----------------------------------------------------


def test_distinct_word_bytes_counts_each_rank_apart():
    idx = torch.tensor([[[0, 0, 3], [3, 3, 3]], [[0, 1, 1], [2, 2, 2]]])
    # rank 0 reads words {0, 3}, rank 1 words {0, 1, 2}
    assert chip_smoke.distinct_word_bytes(idx) == 4 * 5


def test_distinct_word_bytes_one_word_per_rank():
    idx = torch.full((3, 4, 8), 7)
    assert chip_smoke.distinct_word_bytes(idx) == 4 * 3


# --- scatter_least_bytes -----------------------------------------------------


def _scatter_inputs(active):
    p, nb, eb = active.shape
    return (active, torch.zeros((p, nb), dtype=torch.int32),
            torch.zeros((p, nb, eb), dtype=torch.int32))


@pytest.mark.parametrize("hot,sectors", [
    ([], 0),                 # nothing active: no offset is read
    ([0], 1),                # one slot: its 32-byte sector
    ([0, 7], 1),             # two slots of one sector
    ([7, 8], 2),             # neighbours across a sector boundary
    (list(range(32)), 4),    # all active: every sector
])
def test_scatter_least_bytes_counts_active_sectors(hot, sectors):
    active = torch.zeros(1, 2, 16, dtype=torch.bool)
    active.view(-1)[hot] = True
    a, win, dst = _scatter_inputs(active)
    out_words = 64
    want = a.numel() + 4 * win.numel() + 4 * out_words + 32 * sectors
    assert chip_smoke.scatter_least_bytes(a, win, dst, out_words) == want


def test_scatter_least_bytes_pads_a_ragged_tail():
    active = torch.zeros(1, 1, 12, dtype=torch.bool)  # 1.5 sectors of offsets
    active[0, 0, 11] = True
    a, win, dst = _scatter_inputs(active)
    assert chip_smoke.scatter_least_bytes(a, win, dst, 0) == 12 + 4 + 32


def test_scatter_least_bytes_full_activity_reads_every_offset():
    active = torch.ones(2, 3, 64, dtype=torch.bool)
    a, win, dst = _scatter_inputs(active)
    assert chip_smoke.scatter_least_bytes(a, win, dst, 10) == (
        chip_smoke.nbytes(a, win, dst) + 40)


# --- site_launches -----------------------------------------------------------

_FULL = dict(gather_full=1, pull_gather_full=1)
_WINDOWED = dict(gather_full=0, pull_gather_full=0)


def _counts(full, win, scatter, merge=0):
    return dict(frontier_gather_full=full, frontier_gather=win,
                frontier_scatter=scatter, bitmap_or_reduce=merge)


@pytest.mark.parametrize("meta,counts,push,pull", [
    (_FULL, _counts(9 + 2 * 4, 0, 13), 9, 4),     # direction-optimizing, full gathers
    (_WINDOWED, _counts(4, 9 + 4, 13), 9, 4),     # windowed push and visited gathers
    (dict(gather_full=0, pull_gather_full=1), _counts(2 * 4, 9, 13), 9, 4),
    (_WINDOWED, _counts(0, 1025, 1025, 2050), 1025, 0),  # top-down torus
])
def test_site_launches_split_push_and_pull(meta, counts, push, pull):
    got = chip_smoke.site_launches(counts, meta, n_runs=1)
    gather = "frontier_gather_full" if meta["gather_full"] else "frontier_gather"
    assert got[(gather, "tdg_src")] == push
    assert got[("frontier_scatter", "tds")] == push
    assert got[("frontier_scatter", "pus")] == pull
    assert got[("frontier_gather_full", "in_src_blocks")] == pull
    assert got[("bitmap_or_reduce", "merge")] == counts["bitmap_or_reduce"]


def test_site_launches_per_bfs():
    got = chip_smoke.site_launches(_counts(17, 0, 12, 24), _FULL, n_runs=2)
    assert got[("frontier_scatter", "tds")] == 3.5
    assert got[("frontier_scatter", "pus")] == 2.5
    assert got[("bitmap_or_reduce", "merge")] == 12


@pytest.mark.parametrize("counts", [_counts(5, 0, 13), _counts(9, 4, 9)])
def test_site_launches_rejects_counts_that_do_not_split(counts):
    with pytest.raises(AssertionError):
        chip_smoke.site_launches(counts, _FULL, n_runs=1)


# --- edge-case inputs --------------------------------------------------------


def test_placed_view_is_misaligned_contiguous_and_equal():
    for dtype in (torch.bool, torch.int32):
        t = torch.arange(64).reshape(2, 32).to(dtype)
        v = chip_smoke._placed(t, True)
        assert v.is_contiguous() and torch.equal(v, t)
        assert v.data_ptr() % 16 != 0
        assert not build.vectorizable(16, v)
        assert chip_smoke._placed(t, False) is t


@pytest.mark.parametrize("ordered", [True, False])
def test_sorted_offsets_stay_in_the_window_with_padding(ordered):
    gen = torch.Generator().manual_seed(3)
    bits = 64 * 32
    x = chip_smoke._sorted_offsets(3, 5, 512, bits, gen, torch.device("cpu"),
                                   ordered=ordered)
    assert x.dtype == torch.int32 and x.shape == (3, 5, 512)
    assert int(x.min()) >= 0 and int(x.max()) <= bits
    if ordered:
        assert torch.all(x[..., 1:] >= x[..., :-1])  # padding sorts to the tail


def test_edge_cases_cover_the_warp_per_block_hazards():
    scatter, gather = chip_smoke.SCATTER_CASES, chip_smoke.GATHER_CASES
    assert {c[0] for c in scatter} >= {1, 16} and {c[0] for c in gather} >= {1, 16}
    assert 1 in {c[1] for c in scatter} and 1 in {c[1] for c in gather}
    assert {c[2] for c in scatter} >= {128, 512, 200}
    assert {c[2] for c in gather} >= {128, 512, 200}
    assert {c[3] for c in scatter} >= {8, 64, 12288}
    assert {c[3] for c in gather} >= {8, 32, 64, 4096}
    assert {c[5] for c in scatter} >= {0.0, 1.0, 0.02}
    assert any(c[6] for c in scatter) and any(c[6] for c in gather)
    assert any(c[7] for c in scatter) and any(c[7] for c in gather)


def test_full_gather_cases_span_every_route_of_the_planner():
    """Both orders of ids (the walk's and the probe's), each with narrow
    and misaligned cases, at bitmaps from one that L1 holds to one over a
    Kronecker scale-23 rank's 279,296 words."""
    cases = chip_smoke.GATHER_FULL_CASES
    for ordered in (True, False):  # both plans of the planner
        on = [c for c in cases if c[7] == ordered]
        assert any(c[2] % 16 for c in on) or any(c[5] for c in on), ordered
        assert min(c[3] for c in on) <= 8192 and max(c[3] for c in on) > 279296
    assert any(c[2] % 16 for c in cases) and any(c[5] for c in cases)
    assert {c[0] for c in cases} >= {1, 16}
    assert 200 in {c[2] for c in cases} and 1 in {c[1] for c in cases}
    assert any(c[6] for c in cases) and any(c[7] for c in cases)


def test_full_gather_inputs_reach_bit_31_of_the_last_word():
    gen = torch.Generator().manual_seed(1)
    case = (4, 3, 200, 40, 0.5, True, True, True)
    words, src = chip_smoke.full_gather_inputs(case, gen, torch.device("cpu"))
    bits = 40 * 32
    assert words.shape == (4, 40) and src.shape == (4, 3, 200)
    assert not build.vectorizable(200, src) and words.data_ptr() % 16
    assert torch.all(src[:, 0] == bits - 1) and torch.all(src[:, -1, -1] == bits - 1)
    assert torch.all(src[:, 1:, :-1] < bits) and torch.all(src[:, 1] >= 0)
    assert torch.all(src[:, 1, 1:] >= src[:, 1, :-1])  # sorted within a block
    got = ref.frontier_gather_full(words, src)
    assert got[::2, 0].all() and got[::2, -1, -1].all()


def test_gather_full_routes_of_a_tree_without_routes():
    """A tree whose wrapper takes no ``ids_sorted`` (an older commit under
    ``chip_compare.py``) is held and timed on its one kernel."""
    def frontier_gather_full(words, src):
        return None

    assert chip_smoke.gather_full_routes(frontier_gather_full, False) == [
        ("single", {})]


@pytest.mark.parametrize("ordered,first,second", [(False, "probe", "walk"),
                                                  (True, "walk", "probe")])
def test_gather_full_routes_follow_the_planner(ordered, first, second):
    """The planner's route first (the main path's), then the other, each
    reached through ``ids_sorted``."""
    from repro_torch.kernels.frontier_gather import frontier_gather_full

    assert chip_smoke.gather_full_routes(frontier_gather_full, ordered) == [
        (first, {"ids_sorted": ordered}), (second, {"ids_sorted": not ordered})]


def test_direction_log_records_each_level_and_restores_the_ops():
    from repro_torch.kernels import ops

    push, pull = ops.expand_push, ops.expand_pull
    try:
        ops.expand_push = lambda *a: "push-result"
        ops.expand_pull = lambda *a: "pull-result"
        stub_push, stub_pull = ops.expand_push, ops.expand_pull
        with chip_smoke.direction_log() as seq:
            assert ops.expand_push(1) == "push-result"
            ops.expand_push(1)
            assert ops.expand_pull(1, 2) == "pull-result"
        assert seq == ["push", "push", "pull"]
        assert ops.expand_push is stub_push and ops.expand_pull is stub_pull
    finally:
        ops.expand_push, ops.expand_pull = push, pull
    assert chip_smoke.run_lengths(seq) == "push x2, pull x1"
    assert chip_smoke.run_lengths([]) == ""


def test_edge_cases_run_on_the_plain_path():
    """On the CPU the wrappers take the plain versions, so this checks the
    inputs the cases build are ones both accept (in the window, padding
    only as ``ww * 32``, ids inside the bitmap) rather than the kernels."""
    gen = torch.Generator().manual_seed(0)
    assert chip_smoke.edge_cases(gen, torch.device("cpu")) == (
        len(chip_smoke.SCATTER_CASES) + len(chip_smoke.GATHER_CASES)
        + len(chip_smoke.GATHER_FULL_CASES))


def test_hub_block_sets_only_bit_31_of_the_last_word():
    ww, n_windows = 8, 3
    dst = torch.full((1, 2, 512), ww * 32, dtype=torch.int32)
    dst[0, 0] = ww * 32 - 1
    active = torch.ones(1, 2, 512, dtype=torch.bool)
    win = torch.tensor([[1, 1]], dtype=torch.int32)
    out = ref.frontier_scatter(active, win, dst, n_windows, ww)
    want = torch.zeros(1, n_windows * ww, dtype=torch.int32)
    want[0, 2 * ww - 1] = -(1 << 31)
    assert torch.equal(out, want)


# --- chip_compare.load_tree --------------------------------------------------


def test_load_tree_imports_the_named_tree(tmp_path):
    """``load_tree`` swaps the imported ``repro_torch`` for another tree's
    (here a copy of this one) and leaves that tree's ``src`` first on the
    path; the test puts the modules and the path back."""
    import shutil

    import chip_compare

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(root, "src", "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] == "repro_torch"}
    try:
        build_mod, bfs_mod, run_mod = chip_compare.load_tree(str(tmp_path))
        for mod in (build_mod, bfs_mod, run_mod):
            assert mod.__file__.startswith(str(tmp_path))
        assert build_mod.BUILD_ROOT == tmp_path / "build" / "repro_torch_kernels"
        assert sys.path[0] == str(tmp_path / "src")
    finally:
        sys.path.remove(str(tmp_path / "src"))
        for k in [k for k in sys.modules if k.split(".")[0] == "repro_torch"]:
            del sys.modules[k]
        sys.modules.update(saved)


# --- the other syncs' checks -------------------------------------------------


@pytest.mark.parametrize("sync,branches,depth,want", [
    ("butterfly", [0, 0, 0], 2, 6),
    ("rabenseifner", [0, 0], 2, 4),     # one merge per reduce-scatter round
    ("xla", [0, 0, 0, 0], 2, 4),        # one P-way merge per level
    ("sparse", [1, 2, 2, 1], 2, 4),     # only the overflow-fallback levels
    ("adaptive", [1, 0, 0, 1, 1], 3, 6),
    ("all_to_all", [0, 0], 2, 0),
])
def test_merge_launches_follow_the_branches(sync, branches, depth, want):
    assert chip_smoke.merge_launches(sync, branches, depth) == want


def test_merge_cases_take_the_shapes_of_each_sync():
    from types import SimpleNamespace

    parts = {"pg": SimpleNamespace(p=4, n_words=10)}  # pads to 12 words: chunks of 3
    gen = torch.Generator().manual_seed(0)
    cases = chip_smoke.merge_cases("kron", parts, gen, torch.device("cpu"), 2,
                                   wave_words=20)
    shapes = {c["plane"]: tuple(c["args"][0].shape) for c in cases}
    assert shapes == {"rabenseifner_rs0": (4, 2, 6), "rabenseifner_rs1": (4, 2, 3),
                      "xla": (4, 4, 10), "wave_merge": (4, 2, 20)}
    for c in cases:
        k = c["args"][0].shape[1]
        assert c["bytes"] == chip_smoke.nbytes(c["args"][0]) // k * (k + 1)


def test_level_bytes_splits_the_count_by_level():
    import numpy as np

    from repro_torch.core import collectives

    comm = collectives.Communicator(2, "cpu")
    per_level = chip_smoke.LevelBytes(comm)
    x = torch.zeros((2, 3), dtype=torch.int32)
    for shifts in (1, 0, 2):
        for _ in range(shifts):
            comm.ppermute(x, [1, 0])
        per_level.append(0.5)
    assert list(per_level) == [0.5, 0.5, 0.5]
    np.testing.assert_array_equal(per_level.per_level(), [[12, 12], [0, 0], [24, 24]])


@pytest.fixture(scope="module")
def torus_parts():
    from repro_torch.graph import generators

    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None  # etl waits for the card
    try:
        return chip_smoke.etl("torus", lambda: generators.torus_2d(16), 4,
                              torch.device("cpu"), "top_down")
    finally:
        torch.cuda.synchronize = sync


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ("root", "d\\[root\\]"),
    ("unreached", "component"),
    ("far", "spans"),
])
def test_validate_holds_a_bfs_tree_to_graph500_rules(torus_parts, fault, message):
    from repro_torch.core import bfs

    pg = torus_parts["pg"]
    d_owned = bfs.build_bfs_fn(pg, bfs.BFSConfig(), device="cpu")(
        torus_parts["arrays"], 5)[0].clone()
    flat = d_owned.view(-1)
    slot = torus_parts["check"][3]
    if fault == "root":
        flat[slot[5]] = 1
    elif fault == "unreached":
        flat[slot[200]] = bfs.INF
    elif fault == "far":
        flat[slot[200]] += 3
    if fault is None:
        chip_smoke.validate(torus_parts, 5, d_owned)
    else:
        with pytest.raises(AssertionError, match=message):
            chip_smoke.validate(torus_parts, 5, d_owned)


# --- the weighted traversals' and vertex programs' checks (phases 11-16) -------


@pytest.fixture(scope="module")
def weighted_torus():
    """A weighted torus, its SSSP distances from vertex 5 (Dijkstra) and
    its edges as the chip run holds them."""
    from repro_torch.graph import generators
    from repro_torch.traversal import sssp

    g = generators.torus_2d(12, max_weight=9, seed=1)
    dist = torch.as_tensor(sssp.sssp_reference(g, 5))
    return (torch.as_tensor(g.src.astype("int64")), torch.as_tensor(g.dst.astype("int64")),
            torch.as_tensor(g.weights.astype("int64")), dist, g)


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ("root", "d\\[root\\]"),
    ("long", "relaxes a distance further"),
    ("leaf", "no in-edge on a shortest path"),
    ("unreached", "neighbours an unreached one"),
])
def test_sssp_certificate_holds_distances_to_graph500_rules(weighted_torus, fault, message):
    src, dst, w, dist, _ = weighted_torus
    dist = dist.clone()
    if fault == "root":
        dist[5] = 1
    elif fault == "long":  # one vertex farther than an edge allows
        dist[40] += 1
    elif fault == "leaf":  # nearer than any path, on no other's shortest path
        slack = torch.ones(dist.numel(), dtype=torch.bool)
        slack.scatter_reduce_(0, src, dist[dst] < dist[src] + w, "amin")
        slack &= dist != 0xFFFFFFFF
        slack[5] = False
        dist[int(torch.nonzero(slack)[0])] -= 1
    elif fault == "unreached":
        dist[40] = 0xFFFFFFFF
    if fault is None:
        chip_smoke.sssp_certificate(src, dst, w, dist, 5)
    else:
        with pytest.raises(AssertionError, match=message):
            chip_smoke.sssp_certificate(src, dst, w, dist, 5)


def test_sssp_dist_reads_the_uint32_patterns():
    d_owned = torch.tensor([[0, -1], [7, -2]], dtype=torch.int32)
    slot = torch.tensor([0, 2, 1, 3])
    assert chip_smoke.sssp_dist(d_owned, slot).tolist() == [0, 7, 0xFFFFFFFF, 0xFFFFFFFE]


def test_brandes_identity_on_a_path_and_its_failure():
    """Path 0-1-2-3 from source 0: the dependencies are 2, 1, 0 (vertex 1
    lies on the paths to 2 and 3, vertex 2 on the path to 3), and
    sum(d - 1) over the reached = 0 + 1 + 2."""
    from repro_torch.core.bfs import INF

    levels = torch.tensor([0, 1, 2, 3, INF], dtype=torch.int32)
    assert chip_smoke.brandes_identity(torch.tensor([0.0, 2.0, 1.0, 0.0, 0.0]),
                                       levels) == (3.0, 3.0)
    with pytest.raises(AssertionError, match="Brandes"):
        chip_smoke.brandes_identity(torch.tensor([0.0, 2.0, 1.5, 0.0, 0.0]), levels)


def test_hindex_fixed_point_holds_for_core_numbers_only():
    """A triangle with a pendant vertex: cores 2, 2, 2, 1.  Raising the
    pendant's core, or lowering a triangle vertex's, leaves the fixed
    point."""
    from repro_torch.graph import csr
    from repro_torch.programs import kcore

    g = csr.from_edges(torch.tensor([0, 1, 2, 2]).numpy(), torch.tensor([1, 2, 0, 3]).numpy(), 4)
    src, dst = torch.as_tensor(g.src.astype("int64")), torch.as_tensor(g.dst.astype("int64"))
    core = torch.as_tensor(kcore.kcore_reference(g))
    assert core[:4].tolist() == [2, 2, 2, 1]
    assert chip_smoke.hindex_violations(src, dst, core) == 0
    for v, c in ((3, 2), (0, 1)):
        bad = core.clone()
        bad[v] = c
        assert chip_smoke.hindex_violations(src, dst, bad) >= 1


def test_pagerank_residual_is_small_at_the_fixed_point_only():
    from repro_torch.graph import generators
    from repro_torch.programs import pagerank

    g = generators.kronecker(7, 8, seed=2)
    src, dst = torch.as_tensor(g.src.astype("int64")), torch.as_tensor(g.dst.astype("int64"))
    fixed = torch.as_tensor(pagerank.pagerank_reference(g, tol=1e-13, max_iters=1000))
    assert chip_smoke.pagerank_residual(src, dst, g.n, fixed, 0.85) < 1e-11
    uniform = torch.full((g.n,), 1.0 / g.n, dtype=torch.float64)
    assert chip_smoke.pagerank_residual(src, dst, g.n, uniform, 0.85) > 1e-2


def test_min_id_labels_name_each_component_by_its_smallest_vertex():
    import numpy as np

    assert chip_smoke.min_id_labels(np.array([0, 1, 0, 2, 1, 2])).tolist() == [0, 1, 0, 3, 1, 3]


def test_slice_merge_cases_take_the_butterfly_shape_per_plane():
    gen = torch.Generator().manual_seed(0)
    cases = chip_smoke.slice_merge_cases(gen, torch.device("cpu"), 16, 4,
                                         {"bc_merge": ("bc", 40), "tri_merge": ("tri", 9)})
    assert [(c["plane"], c["path"], tuple(c["args"][0].shape)) for c in cases] == [
        ("bc_merge", "bc", (16, 4, 40)), ("tri_merge", "tri", (16, 4, 9))]
    for c in cases:
        assert c["bytes"] == chip_smoke.nbytes(c["args"][0]) // 4 * 5
    odd = chip_smoke.slice_merge_cases(gen, torch.device("cpu"), 12, 4, {"x": ("p", 5)})
    assert odd[0]["args"][0].shape == (12, 4, 5)  # digit plan [4, 3]: first round K = 4


# --- the mutation phases' helpers (phases 17-20) --------------------------------


@pytest.mark.parametrize("n_delete", [0, 8])
def test_fitting_batch_is_accepted_by_the_in_place_patch(n_delete):
    """The sampled inserts are cut to every rank's slack, so the patch
    takes the batch; the deletes are kept whole."""
    import numpy as np

    from repro_torch.dynamic import delta
    from repro_torch.graph import generators, partition

    g = generators.kronecker(9, 8, seed=2, max_weight=8)
    pg = partition.partition_1d(g, 8)
    ov = delta.DeltaOverlay(g)
    batch, kept = chip_smoke.fitting_batch(ov, pg, np.random.default_rng(0), 4 * pg.emax,
                                           n_delete, 8)
    assert 0 < kept < 4 * pg.emax and batch.insert_src.size == kept
    assert batch.delete_src.size == n_delete and batch.insert_weights.size == kept
    assert delta.apply_update_to_partition(pg, ov.apply(batch))


def test_vertex_slots_map_each_vertex_to_its_owned_row():
    import numpy as np

    from repro_torch.graph import generators, partition

    pg = partition.partition_1d(generators.kronecker(8, 8, seed=1), 4)
    slots = chip_smoke.vertex_slots(pg, torch.device("cpu")).numpy()
    for v in (0, 77, pg.n - 1):
        r = pg.owner_of(v)
        assert slots[v] == r * pg.vmax + v - pg.v_start[r]
    assert np.unique(slots).size == pg.n


@pytest.mark.parametrize("fault", [None, "far", "root"])
def test_certify_levels_holds_bfs_levels_to_the_unit_certificate(fault):
    import numpy as np

    from repro_torch.core import bfs
    from repro_torch.graph import generators

    g = generators.torus_2d(10)
    row = bfs.bfs_reference(g, 3)
    edges = chip_smoke.edge_tensors(g.src, g.dst, np.ones(g.n_edges), torch.device("cpu"))
    if fault == "far":
        row[50] += 2
    elif fault == "root":
        row[3] = 1
    if fault is None:
        chip_smoke.certify_levels(edges, row, 3, torch.device("cpu"))
    else:
        with pytest.raises(AssertionError):
            chip_smoke.certify_levels(edges, row, 3, torch.device("cpu"))


# --- the serving phases (22-24) rehearsed on the CPU --------------------------


@pytest.fixture()
def cpu_card(monkeypatch):
    """The CUDA calls of chip_smoke's phases made no-ops, its event timer a
    stub, and the kernel wrappers the phases reach counted into
    ``build.LAUNCHES`` (their plain route counts nothing): a phase function
    then runs whole on the CPU."""
    from repro_torch.kernels import bitmap_merge, ops

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: 0.0)

    def counting(name, fn):
        def call(*args, **kwargs):
            build.LAUNCHES[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(bitmap_merge, "bitmap_or_reduce",
                        counting("bitmap_or_reduce", bitmap_merge.bitmap_or_reduce))
    for name in ("frontier_gather_full", "frontier_gather", "frontier_scatter"):
        monkeypatch.setattr(ops, name, counting(name, getattr(ops, name)))
    build.reset_launches()
    yield torch.device("cpu")
    build.reset_launches()


@pytest.fixture(scope="module")
def kron10():
    """The weighted Kronecker graph of the full-size phases at scale 10."""
    import unittest.mock as mock

    from repro_torch.graph import generators

    with mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        return chip_smoke.etl("kronecker 10", lambda: generators.kronecker(
            10, 8, seed=0, max_weight=chip_smoke.WEIGHT), 4, torch.device("cpu"),
            "direction_optimizing")


def _single(parts, dev):
    from repro_torch.core import bfs

    cfg = bfs.BFSConfig(fanout=4, mode="direction_optimizing", use_kernels=True)
    return bfs.build_bfs_fn(parts["pg"], cfg, parts["layout"], device=dev)


def test_service_phase_rehearsed_on_the_cpu(kron10, cpu_card):
    from repro_torch.graph import csr
    from repro_torch.traversal import sssp

    dev = cpu_card
    sfn = sssp.build_sssp_fn(kron10["pg"], sssp.SSSPConfig(fanout=4), device=dev)
    roots = csr.largest_component_roots(kron10["g"], 2, np.random.default_rng(2))
    sssp_rows = {int(r): sfn(kron10["arrays"], int(r))[0] for r in roots}
    ranks = {}
    chip_smoke.run_pagerank(kron10, 4, dev, keep=ranks)
    out = chip_smoke.run_service(kron10, 4, 0, dev, _single(kron10, dev), sssp_rows, ranks)
    n = (chip_smoke.SERVICE_ROOTS + chip_smoke.SERVICE_DUPLICATES
         + chip_smoke.SERVICE_CLOSENESS + 4)
    assert out["burst"] == n and out["repeats"] == chip_smoke.SERVICE_REPEATS
    assert out["waves"] == 2  # 40 distinct roots in 32-lane waves
    assert out["coalesced"] >= chip_smoke.SERVICE_DUPLICATES
    assert out["launches"]["bitmap_or_reduce"] > 0
    mut = out["mutation"]
    assert mut["version"] == "0.1"
    assert mut["stats"]["rows_before"] == out["cached_rows"]
    assert mut["stats"]["repaired"] <= chip_smoke.SERVICE_REPAIR_BUDGET
    assert sum(mut["checked"].values()) == mut["stats"]["kept"] + mut["stats"]["repaired"]


def test_service_stream_is_seeded_and_holds_every_algo(kron10):
    burst, repeats = chip_smoke.service_stream(kron10, 0, [5, 9])
    again = chip_smoke.service_stream(kron10, 0, [5, 9])
    assert (burst, repeats) == again
    algos = [a for a, _ in burst]
    assert algos.count("bfs") == chip_smoke.SERVICE_ROOTS + chip_smoke.SERVICE_DUPLICATES
    assert len({r for a, r in burst if a == "bfs"}) == chip_smoke.SERVICE_ROOTS
    assert {r for a, r in burst if a == "closeness"} <= {r for a, r in burst if a == "bfs"}
    assert sorted(r for a, r in burst if a == "sssp") == [5, 9]
    assert algos.count("cc") == algos.count("pagerank") == 1
    assert set(repeats) <= {x for x in burst if x[0] in ("bfs", "closeness")}


def test_serving_cli_phase_rehearsed_on_the_cpu(tmp_path, cpu_card):
    out = chip_smoke.run_serving_cli(9, 8, 4, 4, 0, str(tmp_path), dev_name="cpu",
                                     seconds=3.0)
    assert out["failed"] == 0 and out["completed"] == out["submitted"] == 30
    assert {k: v for k, v in out["faults"]["injected"].items() if v} == {"kill-replica": 1}
    assert out["faults"]["recoveries"] == 1
    assert out["events"] > 0
    for name in ("stats.json", "events.jsonl", "slo_verdict.json"):
        assert (tmp_path / name).exists()


def test_profiler_phase_rehearsed_on_the_cpu(kron10, cpu_card):
    from repro_torch.analytics.engine import BFSQueryEngine
    from repro_torch.core import bfs

    dev = cpu_card
    # a cached wave and SSSP program of the graph, as phase 20 leaves them
    eng = BFSQueryEngine(kron10["pg"], bfs.BFSConfig(fanout=4, mode="direction_optimizing"),
                         lanes=chip_smoke.LANES, device=dev)
    eng.query([1, 2])
    eng.sssp([1])
    root = int(np.flatnonzero(kron10["labels"] == np.bincount(kron10["labels"]).argmax())[0])
    out = chip_smoke.run_profiler(kron10, 4, dev, root, _single(kron10, dev))
    assert out["levels"] == len(out["directions"]) > 0
    assert {c["algo"] for c in out["cache"] if c["supported"]} >= {"bfs", "sssp"}
    assert all(c["reconciled"] for c in out["cache"] if c["supported"])
    assert set(out["kernel_calls"]) >= {"frontier_gather_full", "frontier_scatter"}
    assert out["launches"]["frontier_scatter"] > 0


# --- phase 10b (the hierarchical mesh) rehearsed on the CPU ------------------


@pytest.fixture(scope="module")
def kron10_p8():
    """The weighted Kronecker graph at scale 10 over 8 ranks: pod 2 x data 4."""
    import unittest.mock as mock

    from repro_torch.graph import generators

    with mock.patch.object(torch.cuda, "synchronize", lambda *a, **k: None):
        return chip_smoke.etl("kronecker 10 P8", lambda: generators.kronecker(
            10, 8, seed=0, max_weight=chip_smoke.WEIGHT), 8, torch.device("cpu"),
            "direction_optimizing")


def test_axes_mesh_is_pods_of_four():
    assert chip_smoke.axes_mesh(16).shape == {"pod": 4, "data": 4}
    assert chip_smoke.axes_mesh(8).shape == {"pod": 2, "data": 4}


def test_axes_phase_rehearsed_on_the_cpu(kron10_p8, cpu_card):
    from repro_torch.core import bfs

    dev = cpu_card
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    out, total, (f2, f2_run), merge = chip_smoke.run_axes_bfs(kron10_p8, 4, 0, dev, gen)
    assert set(out) == {f"axes {s} fanout 4" for s in bfs.SYNCS} | {"axes butterfly fanout 2"}
    assert total["bitmap_or_reduce"] > 0 and total["frontier_scatter"] > 0
    a2a = out["axes all_to_all fanout 4"]
    # (2 - 1) + (4 - 1) buffers a level on the mesh, 7 on one axis
    assert a2a["bytes_per_rank"] * 7 == a2a["one_axis_bytes_per_rank"] * 4
    # the dense syncs send the one-axis bytes (pod 2 x data 4 has the
    # digits [2], [4] against [4, 2]: as many messages); the sparse rounds'
    # capacities, clamped at the bitmap's 128 words here, follow the order
    for sync in ("butterfly", "rabenseifner", "xla"):
        rec = out[f"axes {sync} fanout 4"]
        assert rec["bytes_per_rank"] == rec["one_axis_bytes_per_rank"], sync
    assert f2 is out["axes butterfly fanout 2"] and f2["launches"]["bitmap_or_reduce"] > 0
    f2_run()
    assert merge["plane"] == "axes_merge_f2" and merge["max_abs_err"] == 0
    assert merge["shape"] == f"({kron10_p8['pg'].p}, 2, {kron10_p8['pg'].n_words})"
    tools = chip_smoke.run_tools(kron10_p8, 10, 8)
    assert tools["upper_bound"] and tools["step_bytes_train_4k"]["global"] > 0


def test_axes_weighted_phase_rehearsed_on_the_cpu(kron10_p8, cpu_card):
    dev = cpu_card
    rows, slice5 = {}, {}
    slice5.update(chip_smoke.run_sssp(kron10_p8, 4, 0, dev, {"butterfly": 1, "adaptive": 1},
                                      32, keep=rows))
    slice5.update(chip_smoke.run_cc(kron10_p8, 4, dev))
    out = chip_smoke.run_axes_weighted(kron10_p8, 4, dev, rows, slice5)
    assert out["sssp adaptive"]["iters"] == slice5["sssp adaptive"]["iters"][0]
    assert out["cc adaptive"]["iters"] == slice5["cc adaptive"]["iters"]
    assert out["sssp adaptive"]["bytes_per_rank"] > 0
