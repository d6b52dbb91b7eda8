"""PyTorch port, streaming mutations: the delta overlay, the in-place
partition patch, versioning and the incremental repair equal the JAX
package's ``repro.dynamic`` on the same seeded batches, bit for bit
(PageRank's warm-start re-push within the reference's ``PR_SLACK``), and
the repaired rows equal host BFS / Dijkstra on the mutated graph.  Kronecker
scale 9 (``seed=2`` unweighted, ``seed=3`` with weights up to 8) at P = 8,
as ``tests/test_dynamic.py``."""

import numpy as np
import pytest
import torch

from repro.core import bfs as ref_bfs
from repro.dynamic import delta as ref_delta
from repro.dynamic import repair as ref_repair
from repro.dynamic import versioning as ref_versioning
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.traversal import sssp as ref_sssp
from repro_torch.core import bfs
from repro_torch.dynamic import delta, repair, versioning
from repro_torch.graph import generators, partition
from repro_torch.traversal import sssp

INF32 = np.iinfo(np.int32).max
SYNCS = ("butterfly", "sparse", "adaptive", "all_to_all", "xla")
PR_TOL = 1e-5
PR_SLACK = 2 * PR_TOL * 0.85 / 0.15


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAPHS = {
    "u": lambda gen: gen.kronecker(9, 8, seed=2),
    "w": lambda gen: gen.kronecker(9, 8, seed=3, max_weight=8),
}


def _graphs(kind):
    """The reference's and the port's graph of ``kind``."""
    return GRAPHS[kind](ref_gen), GRAPHS[kind](generators)


def _port(rpg):
    return partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                    rpg.arrays())


def _root(g, seed=0):
    return int(ref_csr.largest_component_root(g, np.random.default_rng(seed)))


def _ref_cfg(**kw):
    return ref_sssp.SSSPConfig(axes=("data",), fanout=2, **kw)


def _cfg(**kw):
    return sssp.SSSPConfig(fanout=2, **kw)


def _same_update(got, want):
    for f in ("ins_src", "ins_dst", "ins_w", "ins_is_new", "del_src", "del_dst", "del_w"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f


def _same_partition(tpg, rpg):
    assert tpg.scalars() == {k: int(getattr(rpg, k)) for k in partition.SCALARS}
    want = rpg.arrays()
    got = tpg.arrays()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _mutated(kind, n_insert, n_delete, seed=1):
    """Both packages' partitions of ``kind`` patched in place with the same
    seeded batch: ``(rg, rpg, rov, rupd, tpg, tupd)``."""
    rg, _ = _graphs(kind)
    rpg = ref_part.partition_1d(rg, 8)
    tpg = _port(rpg)
    rov, tov = ref_delta.DeltaOverlay(rg), delta.DeltaOverlay(_graphs(kind)[1])
    mw = 8 if kind == "w" else 0
    rupd = rov.apply(rov.sample_batch(np.random.default_rng(seed), n_insert, n_delete,
                                      max_weight=mw))
    tupd = tov.apply(tov.sample_batch(np.random.default_rng(seed), n_insert, n_delete,
                                      max_weight=mw))
    _same_update(tupd, rupd)
    assert ref_delta.apply_update_to_partition(rpg, rupd)
    assert delta.apply_update_to_partition(tpg, tupd)
    _same_partition(tpg, rpg)
    return rg, rpg, rov, rupd, tpg, tupd


# --- delta overlay and the partition patch ---------------------------------


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_overlay_matches_reference(kind):
    """Three seeded batches and the crafted edge cases of the reference's
    test (a lowering and a raising duplicate insert, a self-loop, a missing
    delete): the same effective updates, edge arrays, counters and
    compaction."""
    rg, tg = _graphs(kind)
    rov, tov = ref_delta.DeltaOverlay(rg), delta.DeltaOverlay(tg)
    mw = 8 if kind == "w" else 0
    for seed in range(3):
        batches = [ov.sample_batch(np.random.default_rng(seed), 10, 5, max_weight=mw)
                   for ov in (rov, tov)]
        _same_update(tov.apply(batches[1]), rov.apply(batches[0]))
    u, v = int(rg.src[0]), int(rg.dst[0])
    w_uv = int(rg.weights[0]) if rg.weighted else 0
    crafted = dict(insert_src=[u, u, 3, 1], insert_dst=[v, v, 3, 2],
                   insert_weights=[max(w_uv - 1, 1), w_uv + 3, 5, 4] if rg.weighted else None,
                   delete_src=[rg.n_real + 1], delete_dst=[0])
    _same_update(tov.apply(delta.EdgeBatch(**crafted)),
                 rov.apply(ref_delta.EdgeBatch(**crafted)))
    for got, want in zip(tov.edge_arrays(), rov.edge_arrays()):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    assert (tov.pending_ops, tov.batches_applied, tov.n_edges, tov.needs_compaction()) == \
        (rov.pending_ops, rov.batches_applied, rov.n_edges, rov.needs_compaction())
    tgc, rgc = tov.compact(), rov.compact()
    for f in ("src", "dst", "row_offsets", "weights"):
        a, b = getattr(tgc, f), getattr(rgc, f)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert tov.pending_ops == 0 and tov.compactions == 1 and tov.base is tgc


def test_overlay_refusals_match_reference():
    rg, tg = _graphs("u")
    rgw, tgw = _graphs("w")
    cases = [
        (lambda m, g, gw: m.DeltaOverlay(g).apply(m.EdgeBatch.insert([0], [1], [5])),
         "unweighted"),
        (lambda m, g, gw: m.DeltaOverlay(gw).apply(m.EdgeBatch.insert([0], [1])), "weight"),
        (lambda m, g, gw: m.DeltaOverlay(g).apply(m.EdgeBatch.insert([0], [g.n + 5])),
         "out of range"),
        (lambda m, g, gw: m.EdgeBatch.insert([0], [1], [0]), ">= 1"),
        (lambda m, g, gw: m.DeltaOverlay(g, compact_ratio=0), "compact_ratio"),
        (lambda m, g, gw: m.EdgeBatch(insert_src=[1, 2], insert_dst=[3]), "mismatch"),
    ]
    for make, match in cases:
        for m, g, gw in ((ref_delta, rg, rgw), (delta, tg, tgw)):
            with pytest.raises(ValueError, match=match):
                make(m, g, gw)


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_partition_patch_matches_reference(kind):
    """Two seeded mixed batches patched in place: every array (weights and
    ``deg_out`` included) equal to the reference's after each, and the
    edge multiset equal to the overlay's current graph."""
    rg, rpg, rov, _, tpg, _ = _mutated(kind, 15, 8)
    tov = delta.DeltaOverlay(_graphs(kind)[1])
    tov.apply(tov.sample_batch(np.random.default_rng(1), 15, 8,
                               max_weight=8 if kind == "w" else 0))
    rupd = rov.apply(rov.sample_batch(np.random.default_rng(2), 12, 6,
                                      max_weight=8 if kind == "w" else 0))
    tupd = tov.apply(tov.sample_batch(np.random.default_rng(2), 12, 6,
                                      max_weight=8 if kind == "w" else 0))
    _same_update(tupd, rupd)
    assert delta.apply_update_to_partition(tpg, tupd)
    assert ref_delta.apply_update_to_partition(rpg, rupd)
    _same_partition(tpg, rpg)
    keys, ws = delta.partition_edge_multiset(tpg)
    rkeys, rws = ref_delta.partition_edge_multiset(rpg)
    np.testing.assert_array_equal(keys, rkeys)
    if rws is None:
        assert ws is None
    else:
        np.testing.assert_array_equal(ws, rws)
    gm = tov.current_graph()
    np.testing.assert_array_equal(keys, (gm.src.astype(np.int64) << 32) | gm.dst)
    back = delta.graph_from_partition(tpg, n_real=gm.n_real)
    rback = ref_delta.graph_from_partition(rpg, n_real=gm.n_real)
    np.testing.assert_array_equal(back.row_offsets, rback.row_offsets)
    np.testing.assert_array_equal(back.dst, gm.dst)


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_overflow_refused_atomically_as_reference(kind):
    """A batch larger than any rank's slack: both packages refuse it and
    leave every array as it was (equal to each other)."""
    rg, tg = _graphs(kind)
    rpg = ref_part.partition_1d(rg, 8)
    tpg = _port(rpg)
    n = 2 * (int(rpg.emax - rpg.edge_count.max()) + rpg.emax)
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, rg.n_real, n), rng.integers(0, rg.n_real, n)
    w = rng.integers(1, 9, n) if kind == "w" else None
    rupd = ref_delta.DeltaOverlay(rg).apply(ref_delta.EdgeBatch.insert(src, dst, w))
    tupd = delta.DeltaOverlay(tg).apply(delta.EdgeBatch.insert(src, dst, w))
    _same_update(tupd, rupd)
    before = {k: v.copy() for k, v in tpg.arrays().items()}
    assert not delta.apply_update_to_partition(tpg, tupd)
    assert not ref_delta.apply_update_to_partition(rpg, rupd)
    for k, v in tpg.arrays().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    _same_partition(tpg, rpg)


def test_partitions_equivalent_matches_reference():
    rg, tg = _graphs("w")
    rg2, tg2 = (m.kronecker(9, 8, seed=11, max_weight=8) for m in (ref_gen, generators))
    _, rpg, rov, _, tpg, _ = _mutated("w", 10, 4)
    fresh_r = ref_part.partition_1d(rov.current_graph(), 8)
    cases = [
        (tpg, tpg, rpg, rpg),
        (_port(ref_part.partition_1d(rg, 8)), partition.partition_1d(tg, 8),
         ref_part.partition_1d(rg, 8), ref_part.partition_1d(rg, 8)),
        (tpg, _port(fresh_r), rpg, fresh_r),
        (partition.partition_1d(tg, 8), partition.partition_1d(tg2, 8),
         ref_part.partition_1d(rg, 8), ref_part.partition_1d(rg2, 8)),
        (partition.partition_1d(tg, 8), partition.partition_1d(tg, 4),
         ref_part.partition_1d(rg, 8), ref_part.partition_1d(rg, 4)),
    ]
    seen = set()
    for a, b, ra, rb in cases:
        want = ref_versioning.partitions_equivalent(ra, rb)
        assert versioning.partitions_equivalent(a, b) == want
        seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_update_stream_crosses_packages(tmp_path, writer):
    """A stream written by either package reads back in the other."""
    batches = [
        dict(insert_src=[1, 2], insert_dst=[3, 4]),
        dict(insert_src=[5], insert_dst=[6], insert_weights=[7], delete_src=[1],
             delete_dst=[3]),
        dict(insert_src=[], insert_dst=[], delete_src=[2], delete_dst=[4]),
    ]
    path = str(tmp_path / "updates.jsonl")
    out, back = (delta, ref_delta) if writer == "port" else (ref_delta, delta)
    out.write_update_stream(path, [out.EdgeBatch(**b) for b in batches])
    got = back.read_update_stream(path)
    assert len(got) == len(batches)
    for b, g in zip(batches, got):
        want = back.EdgeBatch(**b)
        for f in ("insert_src", "insert_dst", "delete_src", "delete_dst"):
            np.testing.assert_array_equal(getattr(g, f), getattr(want, f))
        if want.insert_weights is None:
            assert g.insert_weights is None
        else:
            np.testing.assert_array_equal(g.insert_weights, want.insert_weights)


def test_graph_version_matches_reference():
    for ops in ((), ("delta",), ("epoch",), ("delta", "delta", "epoch", "delta")):
        v, rv = versioning.GraphVersion(), ref_versioning.GraphVersion()
        for op in ops:
            v, rv = getattr(v, f"bump_{op}")(), getattr(rv, f"bump_{op}")()
        assert (v.json(), str(v)) == (rv.json(), str(rv))
    assert versioning.GraphVersion(0, 3) < versioning.GraphVersion(1, 0)


# --- single-row repair -------------------------------------------------------


@pytest.mark.parametrize("sync", SYNCS)
def test_repair_row_bfs_mixed_batch_matches_reference(mesh8, sync):
    """Insert + delete batch, BFS levels: the repaired row, its touched
    count and its iterations equal the reference's under every sync
    ``SSSPConfig`` allows, and the row equals host BFS on the mutated
    graph."""
    rg, rpg, rov, rupd, tpg, tupd = _mutated("u", 20, 10)
    root = _root(rg)
    row0 = ref_bfs.bfs_reference(rg, root)
    want = ref_repair.repair_row(rpg, mesh8, row0, rupd, _ref_cfg(sync=sync),
                                 unit_weight=True)
    got = repair.repair_row(tpg, row0, tupd, _cfg(sync=sync), unit_weight=True,
                            device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] > 0
    np.testing.assert_array_equal(got[0], ref_bfs.bfs_reference(rov.current_graph(), root))


@pytest.mark.parametrize("sync", ["butterfly", "adaptive"])
def test_repair_row_sssp_insert_only_with_lowering_matches_reference(mesh8, sync):
    """Weighted SSSP: a weight-lowering of an existing edge, then a seeded
    insert-only batch (the ``with_taint=False`` program): equal to the
    reference's repair and to Dijkstra on the mutated graph."""
    rg, tg = _graphs("w")
    rpg = ref_part.partition_1d(rg, 8)
    tpg = _port(rpg)
    root = _root(rg)
    rrow = trow = ref_sssp.sssp_reference(rg, root)
    rov, tov = ref_delta.DeltaOverlay(rg), delta.DeltaOverlay(tg)
    e = 5
    low = dict(src=[int(rg.src[e])], dst=[int(rg.dst[e])],
               weights=[max(int(rg.weights[e]) - 1, 1)])
    batches = [(ref_delta.EdgeBatch.insert(**low), delta.EdgeBatch.insert(**low))]
    batches.append((rov.sample_batch(np.random.default_rng(4), 16, 0, max_weight=8),
                    tov.sample_batch(np.random.default_rng(4), 16, 0, max_weight=8)))
    for rb, tb in batches:
        rupd, tupd = rov.apply(rb), tov.apply(tb)
        assert rupd.del_src.size == 0
        assert ref_delta.apply_update_to_partition(rpg, rupd)
        assert delta.apply_update_to_partition(tpg, tupd)
        want = ref_repair.repair_row(rpg, mesh8, rrow, rupd, _ref_cfg(sync=sync))
        got = repair.repair_row(tpg, trow, tupd, _cfg(sync=sync), device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        rrow, trow = want[0], got[0]
    np.testing.assert_array_equal(trow, ref_sssp.sssp_reference(tov.current_graph(), root))


def test_repair_row_sssp_mixed_batch_matches_reference(mesh8):
    rg, rpg, rov, rupd, tpg, tupd = _mutated("w", 16, 8, seed=3)
    root = _root(rg)
    row0 = ref_sssp.sssp_reference(rg, root)
    want = ref_repair.repair_row(rpg, mesh8, row0, rupd, _ref_cfg())
    got = repair.repair_row(tpg, row0, tupd, _cfg(), device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], ref_sssp.sssp_reference(rov.current_graph(), root))


def test_repair_unchanged_proof_is_free():
    """An insert between two vertices at the same level proves the row
    unchanged on the host: the row itself comes back, touched 0, no
    iteration (and, so, no work on any device)."""
    rg, tg = _graphs("u")
    root = _root(rg)
    row0 = ref_bfs.bfs_reference(rg, root)
    lvl = np.flatnonzero(row0 == 2)
    existing = set(zip(rg.src.tolist(), rg.dst.tolist()))
    pair = next((int(a), int(b)) for i, a in enumerate(lvl) for b in lvl[i + 1:]
                if (int(a), int(b)) not in existing)
    tov = delta.DeltaOverlay(tg)
    upd = tov.apply(delta.EdgeBatch.insert([pair[0]], [pair[1]]))
    assert not upd.empty
    relax_ids, taint_ids = repair.repair_seeds(row0, upd, unit_weight=True)
    assert relax_ids.size == 0 and taint_ids.size == 0
    tpg = partition.partition_1d(tg, 8)
    assert delta.apply_update_to_partition(tpg, upd)
    new_row, touched, iters = repair.repair_row(tpg, row0, upd, _cfg(), unit_weight=True,
                                                device="cpu")
    assert touched == 0 and iters == 0 and new_row is row0
    np.testing.assert_array_equal(ref_bfs.bfs_reference(tov.current_graph(), root), row0)


@pytest.mark.parametrize("sync", ["butterfly", "sparse", "adaptive"])
def test_repair_trace_rows_match_reference(mesh8, sync):
    """``trace=True``: the taint rounds (DIR 0, OR stats) and the relax
    iterations (DIR 1, MIN stats) equal the reference's rows, and the
    traced output equals the untraced one."""
    rg, rpg, _, rupd, tpg, tupd = _mutated("u", 20, 10)
    row0 = ref_bfs.bfs_reference(rg, _root(rg))
    n_rows = sssp.dist_rows(tpg)
    nw = n_rows // 32
    relax_ids, taint_ids = repair.repair_seeds(row0, tupd, unit_weight=True)
    assert taint_ids.size
    ops = (repair.encode_distances(row0, n_rows), repair.seed_words(taint_ids, nw),
           repair.seed_words(relax_ids, nw))
    rfn = ref_repair.build_repair_fn(rpg, mesh8, _ref_cfg(sync=sync), unit_weight=True,
                                     trace=True, trace_levels=32)
    want = rfn(ref_bfs.place_arrays(rpg, mesh8, ("data",)), *ops)
    fn = repair.build_repair_fn(tpg, _cfg(sync=sync), unit_weight=True, trace=True,
                                trace_levels=32, device="cpu")
    arrays = bfs.place_arrays(tpg, device="cpu")
    got = fn(arrays, *ops)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
    assert got[1] == int(np.max(want[1])) and got[2] == int(np.asarray(want[2])[0])
    rows = np.asarray(want[3])[0]
    np.testing.assert_array_equal(got[3].numpy(), rows)
    assert set(rows[: got[1], 3]) == {0, 1}
    plain = repair.build_repair_fn(tpg, _cfg(sync=sync), unit_weight=True,
                                   device="cpu")(arrays, *ops)
    assert torch.equal(plain[0], got[0]) and plain[1:] == got[1:3]


def test_repair_needs_weights_for_sssp():
    _, tg = _graphs("u")
    tpg = partition.partition_1d(tg, 8)
    with pytest.raises(ValueError, match="weighted"):
        repair.build_repair_fn(tpg, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="weighted"):
        repair.build_repair_wave_fn(tpg, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="lane_words"):
        repair.build_repair_wave_fn(tpg, _cfg(), 0, unit_weight=True, device="cpu")


def test_repair_seed_helpers_match_reference():
    rg, _, _, rupd, _, tupd = _mutated("w", 20, 10)
    row = ref_sssp.sssp_reference(rg, _root(rg))
    for unit in (True, False):
        for got, want in zip(repair.repair_seeds(row, tupd, unit_weight=unit),
                             ref_repair.repair_seeds(row, rupd, unit_weight=unit)):
            np.testing.assert_array_equal(got, want)
    ids = np.array([0, 31, 32, 63, 95, 31])
    np.testing.assert_array_equal(repair.seed_words(ids, 4), ref_repair.seed_words(ids, 4))
    np.testing.assert_array_equal(repair.encode_distances(row, 600),
                                  ref_repair.encode_distances(row, 600))


# --- lane-packed repair -------------------------------------------------------


def _rows_case(kind, n_roots, sync="butterfly", seed=1, n_insert=20, n_delete=10):
    rg, rpg, rov, rupd, tpg, tupd = _mutated(kind, n_insert, n_delete, seed=seed)
    roots = [int(r) for r in ref_csr.largest_component_roots(
        rg, n_roots, np.random.default_rng(0))]
    oracle = ref_bfs.bfs_reference if kind == "u" else ref_sssp.sssp_reference
    rows = [oracle(rg, r) for r in roots]
    return rg, rpg, rov, rupd, tpg, tupd, roots, rows, oracle


def _same_outcomes(got, want, rows):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
            continue
        np.testing.assert_array_equal(a[0], b[0], err_msg=str(i))
        assert a[1:] == b[1:], (i, a[1:], b[1:])
        if a[1] == 0:
            assert a[0] is rows[i]


@pytest.mark.parametrize("n_roots", [1, 33])
def test_repair_rows_bfs_matches_reference(mesh8, n_roots):
    """One suspect (the single-row program) and 33 (two lane waves, the
    first with lane bit 31 set): every outcome equals the reference's and
    host BFS on the mutated graph."""
    rg, rpg, rov, rupd, tpg, tupd, roots, rows, oracle = _rows_case("u", n_roots)
    want = ref_repair.repair_rows(rpg, mesh8, rows, rupd, _ref_cfg(), unit_weight=True)
    got = repair.repair_rows(tpg, rows, tupd, _cfg(), unit_weight=True, device="cpu")
    suspects = sum(1 for o in got if o[2] > 0)
    assert suspects == n_roots
    _same_outcomes(got, want, rows)
    gm = rov.current_graph()
    for r, o in zip(roots, got):
        np.testing.assert_array_equal(o[0], oracle(gm, r))


def test_repair_rows_sssp_pad_lanes_and_budget_match_reference(mesh8):
    """Weighted rows (7 suspects: 25 pad lanes) and a ``max_repairs``
    budget that drops the suspects past it: the same outcomes, ``None``
    at the same places."""
    rg, rpg, rov, rupd, tpg, tupd, roots, rows, oracle = _rows_case("w", 7)
    for budget in (None, 3):
        want = ref_repair.repair_rows(rpg, mesh8, rows, rupd, _ref_cfg(), max_repairs=budget)
        got = repair.repair_rows(tpg, rows, tupd, _cfg(), max_repairs=budget, device="cpu")
        _same_outcomes(got, want, rows)
        assert sum(o is None for o in got) == (0 if budget is None else 4)
    gm = rov.current_graph()
    for r, o in zip(roots, repair.repair_rows(tpg, rows, tupd, _cfg(), device="cpu")):
        np.testing.assert_array_equal(o[0], oracle(gm, r))


@pytest.mark.parametrize("sync", ["sparse", "adaptive"])
def test_repair_rows_sparse_syncs_match_reference(mesh8, sync):
    rg, rpg, rov, rupd, tpg, tupd, roots, rows, oracle = _rows_case("u", 6)
    want = ref_repair.repair_rows(rpg, mesh8, rows, rupd, _ref_cfg(sync=sync),
                                  unit_weight=True)
    got = repair.repair_rows(tpg, rows, tupd, _cfg(sync=sync), unit_weight=True,
                             device="cpu")
    _same_outcomes(got, want, rows)


def test_repair_rows_insert_only_and_unchanged_rows(mesh8):
    """An insert-only batch (the taint-free wave) over rows some of which
    it proves unchanged (an isolated root's row): outcomes equal the
    reference's, the proven rows returned as they were."""
    rg, rpg, rov, rupd, tpg, tupd, roots, rows, oracle = _rows_case("u", 5, n_delete=0)
    isolated = int(np.flatnonzero(np.diff(rg.row_offsets)[: rg.n_real] == 0)[0])
    rows.append(ref_bfs.bfs_reference(rg, isolated))
    want = ref_repair.repair_rows(rpg, mesh8, rows, rupd, _ref_cfg(), unit_weight=True)
    got = repair.repair_rows(tpg, rows, tupd, _cfg(), unit_weight=True, device="cpu")
    _same_outcomes(got, want, rows)
    assert got[-1][1] == 0 and got[-1][0] is rows[-1]


@pytest.mark.parametrize("kind,with_taint", [("u", True), ("w", True), ("w", False)])
def test_repair_wave_chunks_edge_slots_exactly(kind, with_taint, monkeypatch):
    """The wave's per-edge ``[P, E, L]`` terms in chunks of a few hundred
    elements give what one chunk gives, lane for lane."""
    rg, _, _, _, tpg, tupd, roots, rows, _ = _rows_case(
        kind, 33, n_delete=10 if with_taint else 0)
    n_rows = sssp.dist_rows(tpg)
    dist0 = np.full((n_rows, 32), sssp.UNREACHED, dtype=np.uint32)
    relax = np.zeros((n_rows, 1), dtype=np.uint32)
    taint = np.zeros((n_rows, 1), dtype=np.uint32)
    for b, row in enumerate(rows[:32]):
        dist0[:, b] = repair.encode_distances(row, n_rows)
        r_ids, t_ids = repair.repair_seeds(row, tupd, unit_weight=kind == "u")
        relax[r_ids, 0] |= np.uint32(1) << np.uint32(b)
        taint[t_ids, 0] |= np.uint32(1) << np.uint32(b)
    assert (taint.any() if with_taint else not taint.any())
    arrays = bfs.place_arrays(tpg, device="cpu")
    outs = []
    for chunk in (1 << 26, 300):
        monkeypatch.setattr(repair, "CHUNK_ELEMS", chunk)
        outs.append(repair.build_repair_wave_fn(tpg, _cfg(), unit_weight=kind == "u",
                                                with_taint=with_taint, device="cpu")(
            arrays, dist0, taint, relax))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


# --- versioning + cache migration ---------------------------------------------


def _fill_cache(cache_mod, version, roots, rows, srows):
    cache = cache_mod.ResultCache(capacity=64)
    for r, row, srow in zip(roots, rows, srows):
        cache.put(cache_mod.result_key(version, "bfs", "cfg", r), row)
        cache.put(cache_mod.result_key(version, "sssp", "cfg", r), srow)
        cache.put(cache_mod.result_key(version, "closeness", "cfg", r), float(r))
        cache.put(cache_mod.result_key(version, "bc", "cfg", r), row * 0.5)
    cache.put(cache_mod.result_key(version, "closeness", "cfg", 10_000), 1.0)
    return cache


def test_migrate_cache_matches_reference(mesh8):
    """``migrate_cache`` over the reference's ``ResultCache`` with the
    port's repairers gives the reference's ``InvalidationStats`` and the
    same rows under the new version."""
    from repro.service import cache as cache_mod

    rg, rpg, rov, rupd, tpg, tupd, roots, rows, _ = _rows_case("w", 5)
    brows = [ref_bfs.bfs_reference(rg, r) for r in roots]
    old, new = ref_versioning.GraphVersion(0, 0), ref_versioning.GraphVersion(0, 1)
    derive = lambda row: float(np.sum(row < INF32))  # noqa: E731
    ref_cache = _fill_cache(cache_mod, old, roots, brows, rows)
    want = ref_versioning.migrate_cache(ref_cache, old, new, repairers={
        "bfs": lambda rs: ref_repair.repair_rows(rpg, mesh8, rs, rupd, _ref_cfg(),
                                                 unit_weight=True, max_repairs=3),
        "sssp": lambda rs: ref_repair.repair_rows(rpg, mesh8, rs, rupd, _ref_cfg())},
        derive_closeness=derive)
    port_cache = _fill_cache(cache_mod, old, roots, brows, rows)
    got = versioning.migrate_cache(port_cache, old, new, repairers={
        "bfs": lambda rs: repair.repair_rows(tpg, rs, tupd, _cfg(), unit_weight=True,
                                             max_repairs=3, device="cpu"),
        "sssp": lambda rs: repair.repair_rows(tpg, rs, tupd, _cfg(), device="cpu")},
        derive_closeness=derive)
    assert got == versioning.InvalidationStats(**vars(want))
    assert got.dropped > 0 and got.survival_rate == want.survival_rate
    have = dict(port_cache.items_snapshot())
    for key, value in ref_cache.items_snapshot():
        if key[0] == new:
            np.testing.assert_array_equal(have[key], value, err_msg=str(key))
    assert sorted(map(str, have)) == sorted(map(str, dict(ref_cache.items_snapshot())))
    disabled = cache_mod.ResultCache(capacity=0)
    assert versioning.migrate_cache(disabled, old, new, repairers={}) == \
        versioning.InvalidationStats()


def test_repair_rank_rows_matches_reference(mesh8):
    """PageRank's warm-start re-push after a mixed batch: the re-pushed
    ranks within ``PR_SLACK`` of the reference's, the same rounds."""
    from repro import programs as ref_programs
    from repro.core import bfs as rbfs
    from repro_torch import programs

    rg, rpg, _, _, tpg, _ = _mutated("u", 20, 10)
    cold_r = ref_programs.run_program(ref_part.partition_1d(rg, 8), mesh8,
                                      ref_programs.by_name("pagerank"),
                                      ref_programs.ProgramConfig(tol=PR_TOL))[0]
    rows = [cold_r, cold_r * 1.0]
    rcfg = ref_programs.ProgramConfig(tol=PR_TOL)
    rfn = ref_programs.build_program_fn(rpg, mesh8, ref_programs.by_name("pagerank"), rcfg)
    want = ref_programs.repair_rank_rows(rows, pg=rpg, fn=rfn,
                                         arrays=rbfs.place_arrays(rpg, mesh8, ("data",)))
    fn = programs.build_program_fn(tpg, programs.by_name("pagerank"),
                                   programs.ProgramConfig(tol=PR_TOL), device="cpu")
    got = programs.repair_rank_rows(rows, pg=tpg, fn=fn,
                                    arrays=bfs.place_arrays(tpg, device="cpu"))
    for (a, ta, ia), (b, tb, ib) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=PR_SLACK, rtol=0)
        assert ia == ib and ta > 0 and tb > 0
