"""PyTorch port, the cost-model profiler (DESIGN.md §20).

``repro_torch.core.profiler`` against ``repro.core.profiler`` on the
reference's graphs (Kronecker scale 9 and torus 20 x 20, P = 8): the byte
model reconciles EXACTLY with what the ranks shipped (the Communicator's
count, where the reference reads the compiled HLO), the per-level rows'
level, branch, direction, population, density and bytes equal the
reference profile's, the time and byte fractions each sum to one, the
report survives a JSON round trip, and ``cache_report`` reconciles every
supported cached program (BC's forward OR syncs included) while the
vertex programs report ``supported=False``.  The kernel path runs here
through the wrappers' plain versions, whose least-byte tally is the
roofline's memory term.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import bfs as ref_bfs
from repro.core import profiler as ref_profiler
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.analytics.engine import BFSQueryEngine
from repro_torch.core import bfs, profiler
from repro_torch.graph import generators, partition
from repro_torch.kernels import bounds, ref

GRAPHS = {
    "kron9": lambda gen: gen.kronecker(9, 8, seed=1),
    "torus": lambda gen: gen.torus_2d(20),
}
ROW_KEYS = ("level", "branch", "direction", "pop", "density", "bytes_per_node")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_parts = {}


def _pgs(name):
    """``(reference partition, port partition)`` of one graph at P = 8."""
    if name not in _parts:
        rpg = ref_part.partition_1d(GRAPHS[name](ref_gen), 8)
        tpg = partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                       rpg.arrays())
        _parts[name] = (rpg, tpg)
    return _parts[name]


def _rows(prof):
    return [{k: getattr(r, k) for k in ROW_KEYS} for r in prof.per_level]


@pytest.mark.parametrize("name,sync,root", [
    ("kron9", "butterfly", 3), ("kron9", "adaptive", 3), ("torus", "adaptive", 0)])
@pytest.mark.parametrize("kernels", [False, True])
def test_profile_reconciles_and_matches_the_reference(mesh8, name, sync, root, kernels):
    rpg, tpg = _pgs(name)
    want = ref_profiler.profile_bfs(rpg, mesh8, ref_bfs.BFSConfig(axes=("data",), sync=sync,
                                                                  fanout=4), root, iters=1)
    got = profiler.profile_bfs(tpg, bfs.BFSConfig(sync=sync, fanout=4, use_kernels=kernels),
                               root, iters=2, device="cpu")
    assert want.reconciled and got.reconciled
    assert got.wire_efficiency == pytest.approx(1.0)
    assert got.hlo_bytes["total"] == got.model_bytes["total"]
    assert _rows(got) == _rows(want)
    for key in ("algo", "sync", "p", "fanout", "levels", "n_words", "capacity"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.scanned_edges == want.scanned_edges
    assert got.wall_ms > 0 and got.wall_ms_levels > 0
    assert got.achieved_gteps > 0 and got.modeled_gteps > 0
    rows = got.per_level
    assert [r.level for r in rows] == list(range(1, got.levels + 1))
    assert sum(r.time_frac for r in rows) == pytest.approx(1.0)
    assert sum(r.bytes_frac for r in rows) == pytest.approx(1.0)
    rf = got.roofline
    assert rf["t_compute"] == 0.0
    assert rf["collective_wire_bytes"] == got.hlo_bytes["total"]
    assert rf["t_collective"] == pytest.approx(got.hlo_bytes["total"]
                                               / profiler.NVLINK_BYTES_PER_S)
    if kernels:  # the wrappers' plain versions tallied every call
        assert "frontier_scatter" in rf["kernel_calls"]
        # the merges run on dense levels (the torus under adaptive has none)
        dense = any(r.branch != "sparse" for r in got.per_level)
        assert ("bitmap_or_reduce" in rf["kernel_calls"]) == dense
        assert rf["bytes_per_device"] == sum(rf["kernel_bytes"].values()) > 0
        assert rf["t_memory"] == pytest.approx(rf["bytes_per_device"]
                                               / profiler.HBM_BYTES_PER_S)
    else:
        assert rf["bytes_per_device"] == 0 and rf["dominant"] == "collective"


def test_profile_round_trips_through_json():
    _, tpg = _pgs("kron9")
    prof = profiler.profile_bfs(tpg, bfs.BFSConfig(sync="adaptive", fanout=4,
                                                   use_kernels=True), 1, iters=1,
                                device="cpu")
    blob = json.loads(json.dumps(prof.to_dict()))
    assert blob["reconciled"] is True
    assert len(blob["per_level"]) == blob["levels"]
    assert blob["roofline"]["dominant"] in ("compute", "memory", "collective")
    want_keys = set(ref_profiler.ProgramProfile.__dataclass_fields__)
    assert set(blob) == want_keys
    assert set(blob["per_level"][0]) == set(ref_profiler.LevelRow.__dataclass_fields__)
    table = prof.table()
    assert "wire efficiency" in table
    assert table.count("\n") >= prof.levels  # one row per level


def test_engine_cache_report_reconciles_every_supported_program(mesh8):
    from repro.analytics.engine import BFSQueryEngine as RefEngine

    g = generators.kronecker(9, 8, seed=1, max_weight=8)
    pg = partition.partition_1d(g, 8)
    eng = BFSQueryEngine(pg, bfs.BFSConfig(sync="adaptive", fanout=4), lanes=8,
                         device="cpu")
    eng.query([1, 2, 3])
    eng.sssp([2])
    eng.betweenness([1, 4])
    eng.vertex_program("cc")

    report = eng.profile(root=1, iters=1)
    assert report["program"].reconciled
    assert report["program"].roofline["kernel_calls"] == {}  # the plain program here
    cache = report["cache"]
    assert {c.algo for c in cache} == {"bfs", "sssp", "bc", "vp:cc"}
    for entry in cache:
        if entry.supported:
            # every supported cached program must reconcile exactly
            assert entry.reconciled, entry
            assert entry.hlo_bytes["total"] == entry.model_bytes["total"] > 0
            assert entry.n_words > 0 and entry.capacity > 0
        else:
            assert entry.algo.startswith("vp:") and not entry.reconciled
        blob = json.loads(json.dumps(entry.to_dict()))
        assert blob["algo"] == entry.algo
        assert set(blob) == set(ref_profiler.CacheEntryReport.__dataclass_fields__)
    # the reference's engine reports the same programs the same way
    rpg = ref_part.partition_1d(ref_gen.kronecker(9, 8, seed=1, max_weight=8), 8)
    reng = RefEngine(rpg, mesh8, ref_bfs.BFSConfig(axes=("data",), sync="adaptive",
                                                   fanout=4), lanes=8)
    reng.query([1, 2, 3])
    reng.sssp([2])
    want = {(c.algo, c.supported, c.n_words, c.capacity)
            for c in reng.profile(root=1, iters=1)["cache"]}
    assert want <= {(c.algo, c.supported, c.n_words, c.capacity) for c in cache}


def test_bc_forward_bytes_reconcile_only_on_their_own_communicator():
    from repro_torch.analytics import msbfs
    from repro_torch.core import collectives, flightrec
    from repro_torch.traversal import bc

    _, tpg = _pgs("kron9")
    arrays = bfs.place_arrays(tpg, device="cpu")
    fn = bc.build_bc_fn(tpg, bfs.BFSConfig(sync="adaptive", fanout=4), 2, device="cpu",
                        trace=True)
    comm, or_comm = (collectives.Communicator(8, "cpu") for _ in range(2))
    out = fn(arrays, [1, 5], comm, or_comm=or_comm)
    n_words = msbfs.wave_rows(tpg) * msbfs.lane_words(2)
    tr = flightrec.TraversalTrace.from_buffer(
        out[-1], algo="bc", sync="adaptive", p=8, fanout=4, n_words=n_words,
        capacity=bfs.BFSConfig().resolved_capacity(n_words))
    assert flightrec.reconcile_bytes(tr, or_comm.bytes_sent, forward_only=True)["matches"]
    assert comm.bytes_sent[0] > 0  # the dense ADD syncs, counted apart
    with pytest.raises(ValueError, match="BC trace"):
        flightrec.reconcile_bytes(tr, or_comm.bytes_sent)
    # the ADD syncs are not in the rows: the whole count does not reconcile
    total = or_comm.bytes_sent + comm.bytes_sent
    assert not flightrec.reconcile_bytes(tr, total, forward_only=True)["matches"]
    # the split count changes nothing the run computes
    again = fn(arrays, [1, 5])
    assert torch.equal(again[0], out[0])


def test_tally_counts_the_least_bytes_of_each_call_on_the_plain_route():
    from repro_torch.kernels import bitmap_merge, frontier_gather, frontier_scatter

    gen = torch.Generator().manual_seed(0)
    words = torch.randint(-2**31, 2**31 - 1, (4, 64), dtype=torch.int32, generator=gen)
    src = torch.randint(0, 64 * 32, (4, 3, 16), dtype=torch.int32, generator=gen)
    stack = torch.randint(-2**31, 2**31 - 1, (4, 3, 64), dtype=torch.int32, generator=gen)
    active = torch.rand((4, 3, 16), generator=gen) < 0.2
    win = torch.randint(0, 2, (4, 3), dtype=torch.int32, generator=gen)
    dst = torch.randint(0, 8 * 32, (4, 3, 16), dtype=torch.int32, generator=gen)
    ws = torch.randint(0, 8, (4, 3), dtype=torch.int32, generator=gen)
    local = torch.randint(0, 8 * 32, (4, 3, 16), dtype=torch.int32, generator=gen)
    frontier_gather.frontier_gather_full(words, src)  # outside: nothing counted
    with bounds.tallying() as counts:
        got = frontier_gather.frontier_gather_full(words, src)
        frontier_gather.frontier_gather(words, ws, local, ww=8)
        frontier_scatter.frontier_scatter(active, win, dst, n_windows=2, ww=8)
        bitmap_merge.bitmap_or_reduce(stack)
        bitmap_merge.bitmap_or_reduce(stack)
    assert torch.equal(got, ref.frontier_gather_full(words, src))
    distinct = sum(np.unique(src[r].numpy() >> 5).size for r in range(4))
    assert counts["frontier_gather_full"] == 4 * distinct + 4 * src.numel() + src.numel()
    assert counts["bitmap_or_reduce"] == 2 * (4 * 3 * 64 * 4 + 4 * 64 * 4)
    assert counts["frontier_scatter"] == bounds.scatter_least_bytes(active, win, dst,
                                                                     4 * 2 * 8)
    assert counts["frontier_gather"] == bounds.gather_window_bytes(ws, local, 8)
    assert {k: v for k, v in counts.items() if k.startswith("calls:")} == {
        "calls:frontier_gather_full": 1, "calls:frontier_gather": 1,
        "calls:frontier_scatter": 1, "calls:bitmap_or_reduce": 2}
    assert bounds.total_bytes(counts) == sum(
        counts[k] for k in ("frontier_gather_full", "frontier_gather",
                            "frontier_scatter", "bitmap_or_reduce"))
    with pytest.raises(RuntimeError, match="nest"):
        with bounds.tallying():
            with bounds.tallying():
                pass


def test_profile_rejects_bad_iters():
    _, tpg = _pgs("torus")
    with pytest.raises(ValueError, match="iters"):
        profiler.profile_bfs(tpg, bfs.BFSConfig(sync="adaptive"), 0, iters=0,
                             device="cpu")


def test_bfs_run_profile_writes_the_reference_schema(tmp_path, capsys):
    from repro_torch.launch import bfs_run

    out = tmp_path / "profile.json"
    assert bfs_run.main(["--scale", "8", "--ranks", "4", "--device", "cpu", "--roots", "2",
                         "--kernels", "--sync", "adaptive", "--profile", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "bfs_profile/v1" and doc["cache"] == []
    assert doc["program"]["reconciled"] is True
    assert doc["program"]["roofline"]["bytes_per_device"] > 0
    assert "reconciled=True" in capsys.readouterr().out
    assert bfs_run.main(["--scale", "8", "--ranks", "4", "--device", "cpu", "--roots", "4",
                         "--num-sources", "4", "--profile", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [c["algo"] for c in doc["cache"]] == ["bfs"] and doc["cache"][0]["reconciled"]
    with pytest.raises(SystemExit):
        bfs_run.main(["--scale", "8", "--device", "cpu", "--algo", "sssp", "--profile"])
