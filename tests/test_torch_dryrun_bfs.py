"""The dry run's BFS cell against a real run: at a real Kronecker scale 10
partition over 8 ranks (one data axis, and pod 2 x data 4), the cell's
modeled dense-level bytes and sends (``dryrun.bfs_level_terms``) equal the
Communicator's count of one dense top-down level of a real CPU run
through the kernels' wrappers, its collective record equals the
Communicator's, its merges' least bytes equal the level's tally exactly,
and its modeled least bytes bound the level's ``kernels/bounds.py`` tally
from above."""

import os
import sys

import numpy as np
import pytest

from repro_torch.core import bfs, collectives
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph import generators, partition
from repro_torch.kernels import blocks, bounds
from repro_torch.launch import dryrun, hlo_stats

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MESHES = {"data 8": (SimMesh(8), ("data",)),
          "pod 2 x data 4": (SimMesh((2, 4), ("pod", "data")), ("pod", "data"))}


@pytest.fixture(scope="module")
def kron():
    pg = partition.partition_1d(generators.kronecker(10, 8, seed=3), 8)
    layout = blocks.build_bfs_layout(pg)
    return pg, layout, bfs.place_arrays(pg, layout, device="cpu")


@pytest.mark.parametrize("fanout", [2, 4])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("sync", ["butterfly", "adaptive", "xla"])
def test_bfs_level_terms_equal_a_real_level(kron, mesh_name, fanout, sync):
    pg, layout, arrays = kron
    mesh, axes = MESHES[mesh_name]
    cfg = bfs.BFSConfig(axes=axes, fanout=fanout, sync="butterfly" if sync == "adaptive"
                        else sync, mode="top_down", max_levels=1, use_kernels=True)
    root = int(np.argmax(np.bincount(pg.edge_src[pg.edge_src >= 0], minlength=pg.n)))
    comm = collectives.Communicator(mesh, "cpu")
    with bounds.tallying() as counts:
        _, levels, _ = bfs.build_bfs_fn(pg, cfg, layout, device="cpu", mesh=mesh)(
            arrays, root, comm)
    assert levels == 1
    terms = dryrun.bfs_level_terms(pg, bfs.BFSConfig(axes=axes, fanout=fanout, sync=sync),
                                   mesh)
    assert (comm.bytes_sent == terms["bytes_sent"]).all()
    assert (comm.sends == terms["sends"]).all()
    assert terms["collectives"] == hlo_stats.collective_stats(comm)
    assert terms["least_bytes"]["merge"] == counts.get("bitmap_or_reduce", 0)
    assert terms["least_bytes_total"] >= bounds.total_bytes(counts) > 0


def test_bfs_cell_row(tmp_path):
    """The cell at scale 10 on pod 2 x data 4: its row's terms, the
    per-level permutes the summary's BFS table reads, arguments from the
    shapes."""
    mesh = MESHES["pod 2 x data 4"][0]
    rec = dryrun.run_bfs_cell(False, str(tmp_path), scale=10, edge_factor=8, fanout=2,
                              mesh=mesh, verbose=False)
    assert rec["status"] == "ok", rec.get("trace")
    shapes = partition.synthetic_shapes(1 << 10, 2 * (1 << 10) * 8, 8)
    assert rec["collectives"]["collective-permute"]["count"] == rec["sends_per_level"] == 3
    assert rec["collective_wire_bytes"] == 3 * shapes.n_words * 4
    assert rec["t_collective"] == rec["collective_wire_bytes"] / hlo_stats.LINK_BW
    assert rec["t_compute"] == 0.0 and rec["source"] == "fake"
    assert rec["memory"]["argument_size_in_bytes"] == sum(
        4 * int(np.prod(s[1:])) for s in shapes.array_shapes().values())
    assert rec["bytes_per_device"] * 8 == sum(rec["least_bytes"].values())


def test_chip_phase_3d_rehearsed(monkeypatch, tmp_path):
    """chip_smoke's phase 3d(b) at scale 10 over 8 ranks on the CPU (phase
    7's config: direction-optimizing, butterfly fanout 4, the kernels'
    wrappers), and 3d(c)'s CLI process on the BFS cell (the LM cell at
    published size takes half a minute)."""
    import torch

    import chip_smoke

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    dev = torch.device("cpu")
    cfg = bfs.BFSConfig(fanout=4, sync="butterfly", mode="direction_optimizing",
                        use_kernels=True)
    parts = chip_smoke.etl("kronecker 10", lambda: generators.kronecker(10, 8, seed=0), 8,
                           dev, cfg.mode)
    root = int(np.argmax(parts["g"].out_degree))
    out = chip_smoke.roofline_bfs(parts, cfg, root, dev)
    assert out["levels"] == len(out["level_ms"]) > 1
    assert out["sends_per_level"] == 3 + 1 and out["model_memory_ms"] > 0
    monkeypatch.setattr(chip_smoke, "LM_ARCH", "butterfly-bfs")
    proc = chip_smoke.start_dryrun_cli(str(tmp_path))
    cli = chip_smoke.finish_dryrun_cli(proc, str(tmp_path), timeout_s=120)
    assert cli["row"]["status"] == "ok" and cli["row"]["source"] == "fake"
