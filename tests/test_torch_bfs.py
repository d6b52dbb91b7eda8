"""PyTorch port, distributed BFS on the CPU: distances, levels and edges
examined equal the JAX package's distributed_bfs (plain and Pallas) on
every tests/test_bfs.py graph, each of the six syncs, fanout and traversal
mode."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import bfs as ref_bfs
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.core import bfs
from repro_torch.graph import csr, generators, partition
from repro_torch.launch import bfs_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = {
    "kron10": lambda gen: gen.kronecker(10, 8, seed=1),
    "urand": lambda gen: gen.uniform_random(600, 3000, seed=2),
    "torus": lambda gen: gen.torus_2d(20),
    "path": lambda gen: gen.path_graph(200),
    "star": lambda gen: gen.star_graph(500),
}
MODES = ("top_down", "bottom_up", "direction_optimizing")
ROOT = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def partitions():
    """P=8 partitions of each graph, the port's carried from the reference's."""
    out = {}
    for name, make in GRAPHS.items():
        rpg = ref_part.partition_1d(make(ref_gen), 8)
        tpg = partition.from_reference(
            {k: getattr(rpg, k) for k in partition.SCALARS}, rpg.arrays())
        out[name] = (rpg, tpg)
    return out


@pytest.fixture(scope="module")
def reference(partitions, mesh8):
    """(graph, mode, use_pallas) -> the reference's (distances, levels,
    scanned), computed once with the butterfly at fanout 4."""
    cache = {}

    def get(name, mode, use_pallas):
        key = (name, mode, use_pallas)
        if key not in cache:
            cfg = ref_bfs.BFSConfig(axes=("data",), fanout=4, mode=mode,
                                    use_pallas=use_pallas)
            cache[key] = ref_bfs.distributed_bfs(partitions[name][0], mesh8, ROOT, cfg)
        return cache[key]

    return get


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("sync", bfs.SYNCS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_matches_reference(partitions, reference, name, mode, sync, fanout,
                               use_kernels):
    want_d, want_levels, want_scanned = reference(name, mode, use_kernels)
    cfg = bfs.BFSConfig(fanout=fanout, sync=sync, mode=mode, use_kernels=use_kernels)
    d, levels, scanned = bfs.distributed_bfs(partitions[name][1], ROOT, cfg, device="cpu")
    np.testing.assert_array_equal(d, want_d)
    assert (levels, scanned) == (want_levels, want_scanned)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_partition_count_invariance(mesh8, use_kernels):
    g = generators.kronecker(10, 8, seed=1)
    want = ref_bfs.distributed_bfs(ref_part.partition_1d(ref_gen.kronecker(10, 8, seed=1), 8),
                                   mesh8, 11, ref_bfs.BFSConfig(axes=("data",)))
    np.testing.assert_array_equal(want[0], bfs.bfs_reference(g, 11))
    cfg = bfs.BFSConfig(use_kernels=use_kernels)
    for p in (1, 2, 4, 8):
        d, levels, scanned = bfs.distributed_bfs(partition.partition_1d(g, p), 11, cfg,
                                                 device="cpu")
        np.testing.assert_array_equal(d, want[0], err_msg=f"P={p}")
        assert (levels, scanned) == want[1:], f"P={p}"


def test_isolated_root(mesh8):
    pg = partition.partition_1d(generators.path_graph(100), 8)  # 100..127 isolated
    want = ref_bfs.distributed_bfs(ref_part.partition_1d(ref_gen.path_graph(100), 8),
                                   mesh8, 120, ref_bfs.BFSConfig(axes=("data",)))
    d, levels, scanned = bfs.distributed_bfs(pg, 120, bfs.BFSConfig(), device="cpu")
    np.testing.assert_array_equal(d, want[0])
    assert (levels, scanned) == want[1:]
    assert d[120] == 0 and np.all(np.delete(d, 120) == bfs.INF)


def test_unreachable_marked_inf(mesh8):
    src, dst = np.array([0, 1]), np.array([1, 2])
    rpg = ref_part.partition_1d(ref_csr.from_edges(src, dst, 10), 8)
    want = ref_bfs.distributed_bfs(rpg, mesh8, 0, ref_bfs.BFSConfig(axes=("data",)))
    pg = partition.partition_1d(csr.from_edges(src, dst, 10), 8)
    d, levels, scanned = bfs.distributed_bfs(pg, 0, bfs.BFSConfig(), device="cpu")
    np.testing.assert_array_equal(d, want[0])
    assert (levels, scanned) == want[1:]
    assert d[5] == bfs.INF


def test_teps_accounting_top_down_total(partitions):
    g = generators.kronecker(10, 8, seed=1)
    d, _, scanned = bfs.distributed_bfs(partitions["kron10"][1], ROOT,
                                        bfs.BFSConfig(use_kernels=True), device="cpu")
    assert scanned == int(g.out_degree[d < bfs.INF].sum())


def test_direction_optimizing_scans_fewer_edges():
    g = generators.kronecker(11, 16, seed=3)
    pg = partition.partition_1d(g, 8)
    root = csr.largest_component_root(g, np.random.default_rng(0))
    _, _, td = bfs.distributed_bfs(pg, root, bfs.BFSConfig(mode="top_down"), device="cpu")
    _, _, do = bfs.distributed_bfs(pg, root, bfs.BFSConfig(mode="direction_optimizing"),
                                   device="cpu")
    assert do < 0.85 * td, (do, td)


def test_config_rejects_unknown_and_unported():
    """Unknown modes and syncs raise; every sync of the reference is
    ported (its parity is test_bfs_matches_reference), and so is every
    monoid of the reference: ``by_name`` returns each with the reference's
    name, identity and sparse mode."""
    with pytest.raises(ValueError, match="mode"):
        bfs.BFSConfig(mode="sideways")
    with pytest.raises(ValueError, match="sync"):
        bfs.BFSConfig(sync="carrier_pigeon")
    assert bfs.SYNCS == ref_bfs.SYNCS
    for sync in bfs.SYNCS:
        assert bfs.BFSConfig(sync=sync).sync == sync
    from repro.core import monoid as ref_monoid
    from repro_torch.core import monoid

    for name in ("min", "max", "add"):
        m, rm = monoid.by_name(name), ref_monoid.by_name(name)
        assert (m.name, m.identity, m.sparse_mode) == (rm.name, rm.identity,
                                                       rm.sparse_mode)


def test_kernel_path_needs_layout_and_valid_root(partitions):
    pg = partitions["star"][1]
    with pytest.raises(ValueError, match="Layout"):
        bfs.build_bfs_fn(pg, bfs.BFSConfig(use_kernels=True), device="cpu")
    run = bfs.build_bfs_fn(pg, bfs.BFSConfig(), device="cpu")
    with pytest.raises(ValueError, match="root"):
        run(bfs.place_arrays(pg, device="cpu"), pg.n)


def test_missing_gpu_raises_instead_of_falling_back(partitions, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pg = partitions["star"][1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.distributed_bfs(pg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        bfs_run.main(["--scale", "6", "--ranks", "2", "--roots", "1"])


def test_cli_runs_on_cpu(capsys):
    assert bfs_run.main(["--scale", "8", "--ranks", "4", "--roots", "8", "--kernels",
                         "--mode", "direction_optimizing", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "GTEP/s" in out


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
