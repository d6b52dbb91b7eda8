"""PyTorch port, bit-parallel multi-source BFS: every lane's distances, the
wave's depth and its edges examined equal the JAX package's
``multi_source_bfs`` on mesh8 (and the sequential reference), across lane
counts, syncs, modes, duplicate and inactive lanes and partition counts;
the lane-packed primitives equal the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analytics import msbfs as ref_msbfs
from repro.core import bfs as ref_bfs
from repro.core import frontier as ref_fr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.analytics import msbfs
from repro_torch.core import bfs
from repro_torch.core import frontier as fr
from repro_torch.graph import partition

INF32 = np.iinfo(np.int32).max
GRAPHS = {
    "kron10": lambda gen: gen.kronecker(10, 8, seed=1),
    "torus": lambda gen: gen.torus_2d(20),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(rpg):
    """The port's partition carried from the reference's."""
    return partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                    rpg.arrays())


@pytest.fixture(scope="module")
def partitions():
    out = {}
    for name, make in GRAPHS.items():
        g = make(ref_gen)
        rpg = ref_part.partition_1d(g, 8)
        out[name] = (g, rpg, _port(rpg))
    return out


def _roots(g, b, seed=0):
    return np.random.default_rng(seed).integers(0, g.n_real, size=b).astype(np.int32)


def _check_wave(mesh8, parts, roots, **kw):
    g, rpg, tpg = parts
    want = ref_msbfs.multi_source_bfs(rpg, mesh8, roots,
                                      ref_bfs.BFSConfig(axes=("data",), fanout=4, **kw))
    got = msbfs.multi_source_bfs(tpg, roots, bfs.BFSConfig(fanout=4, **kw), device="cpu")
    np.testing.assert_array_equal(got[0], want[0], err_msg=str(kw))
    assert got[1:] == want[1:], kw
    for b in (0, len(roots) - 1):
        if roots[b] >= 0:
            np.testing.assert_array_equal(got[0][b], ref_bfs.bfs_reference(g, int(roots[b])))
    return got


@pytest.mark.parametrize("b", [1, 31, 32, 33, 64])
def test_msbfs_matches_reference_per_lane_count(mesh8, partitions, b):
    _check_wave(mesh8, partitions["kron10"], _roots(partitions["kron10"][0], b))


@pytest.mark.parametrize("sync", bfs.SYNCS)
def test_msbfs_sync_modes(mesh8, partitions, sync):
    _check_wave(mesh8, partitions["torus"], _roots(partitions["torus"][0], 32), sync=sync)


@pytest.mark.parametrize("mode", bfs.MODES)
def test_msbfs_traversal_modes(mesh8, partitions, mode):
    _check_wave(mesh8, partitions["kron10"], _roots(partitions["kron10"][0], 7), mode=mode,
                sync="adaptive")


def test_msbfs_duplicate_and_inactive_lanes(mesh8, partitions):
    """Duplicate roots answer identically; -1 lanes stay all-INF."""
    dist, _, _ = _check_wave(mesh8, partitions["kron10"], np.array([5, 5, -1, 9], np.int32),
                             mode="direction_optimizing")
    np.testing.assert_array_equal(dist[0], dist[1])
    assert np.all(dist[2] >= INF32)
    everyone_idle = msbfs.multi_source_bfs(partitions["kron10"][2], [-1, -1], device="cpu")
    assert everyone_idle[1:] == (0, 0.0) and np.all(everyone_idle[0] == INF32)


def test_msbfs_partition_count_invariance(partitions):
    g = partitions["kron10"][0]
    roots = _roots(g, 7)
    want = np.stack([ref_bfs.bfs_reference(g, int(r)) for r in roots])
    for p in (1, 4):
        dist, _, _ = msbfs.multi_source_bfs(_port(ref_part.partition_1d(g, p)), roots,
                                            bfs.BFSConfig(), device="cpu")
        np.testing.assert_array_equal(dist, want, err_msg=f"P={p}")


def test_msbfs_scanned_matches_single_source_sum(partitions):
    """Aggregate edges examined == the sum of single-source counts."""
    _, _, tpg = partitions["kron10"]
    cfg = bfs.BFSConfig(fanout=4)
    roots = _roots(partitions["kron10"][0], 5)
    _, _, scanned = msbfs.multi_source_bfs(tpg, roots, cfg, device="cpu")
    assert scanned == sum(bfs.distributed_bfs(tpg, int(r), cfg, device="cpu")[2]
                          for r in roots)


def test_msbfs_rejects_kernels_and_bad_roots(partitions):
    _, _, tpg = partitions["kron10"]
    with pytest.raises(NotImplementedError):
        msbfs.build_msbfs_fn(tpg, bfs.BFSConfig(use_kernels=True), 4, device="cpu")
    arrays = bfs.place_arrays(tpg, device="cpu")
    for expand, args in ((bfs._expand_push, (None, 8, True)),
                         (bfs._expand_pull, (None, None, 8, True))):
        with pytest.raises(NotImplementedError):
            expand(arrays, *args, lanes=True)
    with pytest.raises(ValueError):
        msbfs.multi_source_bfs(tpg, [tpg.n + 7], device="cpu")
    with pytest.raises(ValueError):
        msbfs.multi_source_bfs(tpg, [], device="cpu")
    with pytest.raises(ValueError):
        msbfs.build_msbfs_fn(tpg, bfs.BFSConfig(), 0, device="cpu")
    with pytest.raises(ValueError, match="roots"):
        msbfs.build_msbfs_fn(tpg, bfs.BFSConfig(), 3, device="cpu")(arrays, [1, 2])


def test_msbfs_missing_gpu_raises(partitions, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        msbfs.multi_source_bfs(partitions["kron10"][2], [1, 2])


@pytest.mark.parametrize("k", [1, 2])
def test_lane_primitives_match_reference(k):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, size=(50, k), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0x80000000
    t = torch.from_numpy(words.view(np.int32).copy())
    bits = fr.lane_unpack(t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_fr.lane_unpack(jnp.asarray(words))))
    np.testing.assert_array_equal(fr.lane_pack(bits).view(torch.uint32).numpy(), words)
    np.testing.assert_array_equal(fr.popcount_lanes(t).numpy(),
                                  np.asarray(ref_fr.popcount_lanes(jnp.asarray(words))))
    idx = rng.integers(0, 23, size=50).astype(np.int32)  # duplicates and dropped rows
    idx[:3] = [4, 4, 4]
    want = ref_fr.scatter_or_lanes(20, jnp.asarray(idx), jnp.asarray(words))
    got = fr.scatter_or_lanes(20, torch.from_numpy(idx), t)
    np.testing.assert_array_equal(got.view(torch.uint32).numpy(), np.asarray(want))
    two = fr.scatter_or_lanes(20, torch.from_numpy(np.stack([idx, idx[::-1]])),
                              torch.stack([t, t.flip(0)]))
    assert torch.equal(two[0], got) and torch.equal(two[1], got)  # per-rank rows


def test_msbfs_merges_go_through_the_kernel_wrapper(partitions, monkeypatch):
    """Phase 1 is plain PyTorch, but every dense round of the wave's sync
    calls ``bitmap_or_reduce`` (the kernel on the card): one per round."""
    from repro_torch.core import collectives
    from repro_torch.kernels import bitmap_merge

    calls = []
    real = bitmap_merge.bitmap_or_reduce
    monkeypatch.setattr(bitmap_merge, "bitmap_or_reduce",
                        lambda stack: calls.append(stack.shape) or real(stack))
    _, _, tpg = partitions["kron10"]
    _, levels, _ = msbfs.multi_source_bfs(tpg, [3, 5], bfs.BFSConfig(fanout=4), device="cpu")
    depth = len(collectives.Communicator(8, "cpu").schedule(4).rounds)
    assert len(calls) == levels * depth
    assert calls[0] == (8, 4, msbfs.wave_rows(tpg) * msbfs.lane_words(2))
