"""PyTorch port, the sparse, adaptive, Rabenseifner, all-to-all and xla
frontier syncs: each equals the JAX package's collective on mesh8 and its
host oracle (``simulate_or_sparse``, ``simulate_reduce_scatter_allgather``)
exactly, the Communicator's byte count equals the byte model exactly, and
the BFS under the sparse syncs equals the reference's distances, levels
and edges examined."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import bfs as ref_bfs
from repro.core import butterfly as ref_bf
from repro.core import collectives as ref_coll
from repro.core import frontier as ref_fr
from repro.graph import csr as ref_csr
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.core import bfs, butterfly, collectives
from repro_torch.core import frontier as fr
from repro_torch.graph import partition

NW = 256
CAPACITY = 16
THRESHOLD = 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _u32(t):
    return t.contiguous().view(torch.uint32).numpy()


def _bitmaps(p, active_words, seed=0, nw=NW):
    """Per-rank bitmaps with exactly ``active_words`` nonzero words each."""
    rng = np.random.default_rng(seed)
    x = np.zeros((p, nw), np.uint32)
    for r in range(p):
        ii = rng.choice(nw, size=active_words, replace=False)
        x[r, ii] = rng.integers(1, 2**32, size=active_words, dtype=np.uint32)
    return x


def _mesh(p):
    return jax.make_mesh((p,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


def _ref_run(fn, x):
    """The reference's collective on a ``len(x)``-device mesh, rank by rank."""
    sm = jax.shard_map(lambda v: fn(v[0])[None], mesh=_mesh(x.shape[0]),
                       in_specs=P("data"), out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(sm)(x))


def _run(fn, x, **kw):
    comm = collectives.Communicator(x.shape[0], "cpu")
    return _u32(fn(_t(x), comm, **kw)), comm.bytes_sent.tolist()


# --- sparse and adaptive collectives ----------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("fanout", [1, 2, 4])
@pytest.mark.parametrize("active", [3, 40])  # below / above CAPACITY
def test_sparse_collective_matches_oracle_and_dense(p, fanout, active):
    x = _bitmaps(p, active, seed=p * 10 + fanout)
    want = np.bitwise_or.reduce(x, axis=0)
    got, sent = _run(collectives.butterfly_or_sparse, x, fanout=fanout, capacity=CAPACITY)
    sim, stats = ref_bf.simulate_or_sparse(list(x), fanout, CAPACITY)
    assert stats["mode"] == ("sparse" if active <= CAPACITY else "dense")
    for r in range(p):
        np.testing.assert_array_equal(got[r], want)
        np.testing.assert_array_equal(sim[r], want)
    assert sent == [stats["bytes_per_node"]] * p
    if p == 8:
        np.testing.assert_array_equal(got, _ref_run(
            lambda v: ref_coll.butterfly_or_sparse(v, "data", fanout=fanout,
                                                   capacity=CAPACITY), x))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("fanout", [1, 2, 4])
@pytest.mark.parametrize("active", [2, 60])  # density across the threshold
def test_adaptive_collective_correct_both_sides_of_threshold(p, fanout, active):
    x = _bitmaps(p, active, seed=p + fanout)
    got, sent = _run(collectives.butterfly_or_adaptive, x, fanout=fanout,
                     capacity=CAPACITY, density_threshold=THRESHOLD)
    for r in range(p):
        np.testing.assert_array_equal(got[r], np.bitwise_or.reduce(x, axis=0))
    pops = max(int(np.unpackbits(r.view(np.uint8)).sum()) for r in x)
    go = pops <= int(THRESHOLD * NW * 32) and active <= CAPACITY
    assert go == (active == 2)
    want = (butterfly.bytes_per_node_sparse(p, fanout, CAPACITY, NW) if go
            else butterfly.bytes_per_node_allreduce(p, fanout, NW * 4))
    assert sent == [want] * p
    if p == 8:
        np.testing.assert_array_equal(got, _ref_run(
            lambda v: ref_coll.butterfly_or_adaptive(
                v, "data", fanout=fanout, capacity=CAPACITY,
                density_threshold=THRESHOLD), x))


def test_sparse_uneven_ranks_trigger_fallback():
    """One overflowing rank flips EVERY rank to the dense path (the guard
    is over all ranks); the merge stays correct and ships dense bytes."""
    p = 4
    x = _bitmaps(p, 2, seed=7)
    rng = np.random.default_rng(8)
    ii = rng.choice(NW, size=CAPACITY + 20, replace=False)
    x[2, ii] = rng.integers(1, 2**32, size=ii.size, dtype=np.uint32)
    got, sent = _run(collectives.butterfly_or_sparse, x, fanout=2, capacity=CAPACITY)
    sim, stats = ref_bf.simulate_or_sparse(list(x), 2, CAPACITY)
    assert stats["mode"] == "dense"
    for r in range(p):
        np.testing.assert_array_equal(got[r], np.bitwise_or.reduce(x, axis=0))
        np.testing.assert_array_equal(sim[r], got[r])
    assert sent == [butterfly.bytes_per_node_allreduce(p, 2, NW * 4)] * p


def test_sparse_receive_keeps_bit31_at_word0():
    """A rank whose one active word is word 0 with bit 31 set: its pairs
    travel beside (0, 0) pads, and the OR keeps the bit on every rank."""
    x = np.zeros((4, NW), np.uint32)
    x[1, 0] = 0x80000000
    x[2, 0], x[2, 9] = 0x1, 0x80000000
    got, _ = _run(collectives.butterfly_or_sparse, x, fanout=2, capacity=CAPACITY)
    want = np.bitwise_or.reduce(x, axis=0)
    assert want[0] == 0x80000001
    for r in range(4):
        np.testing.assert_array_equal(got[r], want)


def test_compact_words_deterministic():
    w = np.zeros(64, np.uint32)
    w[[3, 17, 40]] = [0xdead, 0xbeef, 0x1]
    idx, vals, count, overflow = fr.compact_words(_t(w), 8)
    assert int(count) == 3 and not bool(overflow)
    assert idx[:3].tolist() == [3, 17, 40]
    assert _u32(vals[:3]).tolist() == [0xdead, 0xbeef, 0x1]
    assert not idx[3:].any() and not vals[3:].any()  # padding is (0, 0)
    np.testing.assert_array_equal(_u32(fr.expand_words(64, idx, vals)), w)
    _, _, count, overflow = fr.compact_words(_t(w), 2)
    assert int(count) == 3 and bool(overflow)


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_compact_words_matches_reference_per_rank(capacity):
    x = _bitmaps(3, 9, seed=capacity, nw=64)
    x[0, 0] = 0x80000000  # bit 31 at word 0
    idx, vals, count, overflow = fr.compact_words(_t(x), capacity)
    for r in range(3):
        want = ref_fr.compact_words(jnp.asarray(x[r]), capacity)
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_u32(vals[r]), np.asarray(want[1]))
        assert (int(count[r]), bool(overflow[r])) == (int(want[2]), bool(want[3]))
        back = fr.scatter_or_words(torch.zeros(64, dtype=torch.int32), idx[r], vals[r])
        np.testing.assert_array_equal(_u32(back), np.asarray(ref_fr.scatter_or_words(
            jnp.zeros(64, jnp.uint32), want[0], want[1])))


# --- byte models -------------------------------------------------------------


def test_byte_model_copies_match_reference():
    for p in range(1, 17):
        for f in (1, 2, 3, 4, 8):
            assert dataclasses.astuple(butterfly.build_schedule(p, f, msb_first=True)) == \
                dataclasses.astuple(ref_bf.build_schedule(p, f, msb_first=True))
            for fn, args in (("bytes_per_node_rabenseifner", (4096,)),
                             ("sparse_round_capacities", (16, 300)),
                             ("bytes_per_node_sparse", (16, 300)),
                             ("peak_buffer_elems", (1000,))):
                assert getattr(butterfly, fn)(p, f, *args) == getattr(ref_bf, fn)(p, f, *args)
    nw = 1 << 16
    cap = nw // 100
    for density, kw in ((0.001, {}), (0.5, {}), (0.005, dict(density_threshold=0.002)),
                        (0.005, dict(density_threshold=0.002, mean_bits_per_word=1.0))):
        assert butterfly.expected_bytes_per_node_adaptive(8, 2, nw, density, cap, **kw) == \
            ref_bf.expected_bytes_per_node_adaptive(8, 2, nw, density, cap, **kw)
    lo = butterfly.expected_bytes_per_node_adaptive(8, 2, nw, 0.001, cap)
    assert lo == butterfly.bytes_per_node_sparse(8, 2, cap, nw)
    assert lo < 0.10 * butterfly.bytes_per_node_allreduce(8, 2, nw * 4)


def test_sparse_byte_model_matches_communicator():
    """bytes_per_node_sparse == what every rank ships through the
    conditional-free sparse rounds (8 bytes a pair: index and word)."""
    p, fanout, cap, nw = 8, 2, 32, 1 << 12
    x = _bitmaps(p, 5, seed=3, nw=nw)
    _, sent = _run(collectives.butterfly_or_sparse, x, fanout=fanout, capacity=cap,
                   fallback=False)
    assert sent == [butterfly.bytes_per_node_sparse(p, fanout, cap, nw)] * p


def test_adaptive_branch_bytes_sparse_below_dense():
    p, nw = 8, 1 << 14
    cap = max(64, nw // 100)
    kw = dict(fanout=2, capacity=cap, density_threshold=0.01)
    _, sparse = _run(collectives.butterfly_or_adaptive, _bitmaps(p, 4, nw=nw), **kw)
    _, dense = _run(collectives.butterfly_or_adaptive, _bitmaps(p, cap + 1, nw=nw), **kw)
    assert dense[0] == butterfly.bytes_per_node_allreduce(p, 2, nw * 4)
    assert sparse[0] == butterfly.bytes_per_node_sparse(p, 2, cap, nw)
    assert sparse[0] <= 0.10 * dense[0]


# --- Rabenseifner, all-to-all and xla ------------------------------------------


@pytest.mark.parametrize("fanout", [1, 2, 4])
@pytest.mark.parametrize("width", [16, 13])  # 13 pads to a multiple of P
def test_rabenseifner_matches_reference_and_psum(mesh8, fanout, width):
    """Float sum: the same merges in the same order as the reference's
    collective, so equal bit for bit; the psum agrees to 1e-5."""
    x = np.random.default_rng(width).normal(size=(8, width)).astype(np.float32)
    comm = collectives.Communicator(8, "cpu")
    got = collectives.butterfly_allreduce_rabenseifner(torch.from_numpy(x), comm,
                                                       fanout=fanout).numpy()
    want = _ref_run(lambda v: ref_coll.butterfly_allreduce_rabenseifner(
        v[None], "data", fanout=fanout)[0], x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.broadcast_to(x.sum(0), x.shape), rtol=1e-5, atol=1e-5)
    padded = width + (-width) % 8
    assert comm.bytes_sent.tolist() == [
        ref_bf.bytes_per_node_rabenseifner(8, fanout, padded * 4)] * 8


@pytest.mark.parametrize("fanout", [1, 2, 3, 4])
@pytest.mark.parametrize("p", [1, 2, 3, 5, 6, 8, 12, 16])
def test_rabenseifner_matches_oracle_and_byte_model(p, fanout):
    """Integer-valued sums (exact in float64) against the reference's host
    oracle, on mixed-radix digit plans; OR through the kernel path."""
    x = np.random.default_rng(p).integers(-50, 50, size=(p, 2 * p)).astype(np.int32)
    comm = collectives.Communicator(p, "cpu")
    got = collectives.butterfly_allreduce_rabenseifner(torch.from_numpy(x), comm,
                                                       fanout=fanout)
    sim = ref_bf.simulate_reduce_scatter_allgather(list(x.astype(np.float64)), fanout)
    np.testing.assert_array_equal(got.numpy(), np.stack(sim).astype(np.int32))
    assert comm.bytes_sent.tolist() == [
        butterfly.bytes_per_node_rabenseifner(p, fanout, 2 * p * 4)] * p
    bits = _bitmaps(p, 3, seed=p, nw=3 * p + 1)
    got, _ = _run(collectives.butterfly_allreduce_rabenseifner, bits, fanout=fanout, op="or")
    np.testing.assert_array_equal(got, np.broadcast_to(np.bitwise_or.reduce(bits, 0),
                                                       bits.shape))


@pytest.mark.parametrize("fanout", [1, 2, 4])
def test_rabenseifner_or_matches_reference(mesh8, fanout):
    x = (np.uint32(1) << np.arange(8, dtype=np.uint32))[:, None] * np.ones((8, 13), np.uint32)
    x[3, 0] = 0x80000000
    got, sent = _run(collectives.butterfly_allreduce_rabenseifner, x, fanout=fanout,
                     op="or")
    want = _ref_run(lambda v: ref_coll.butterfly_allreduce_rabenseifner(
        v, "data", fanout=fanout, op="or"), x)
    np.testing.assert_array_equal(got, want)
    assert np.all(got == np.bitwise_or.reduce(x, axis=0))
    assert sent == [ref_bf.bytes_per_node_rabenseifner(8, fanout, 16 * 4)] * 8


def test_all_to_all_merge_matches_reference(mesh8):
    x = _bitmaps(8, 30, seed=5, nw=40)
    got, sent = _run(collectives.all_to_all_merge, x)
    np.testing.assert_array_equal(got, _ref_run(
        lambda v: ref_coll.all_to_all_merge(v, "data", op="or"), x))
    assert sent == [7 * 40 * 4] * 8


@pytest.mark.parametrize("op", ["or", "add", "max", "min"])
def test_xla_allreduce_matches_reference(mesh8, op):
    """The all-gather + P-way reduce: equal to the reference's psum, pmax,
    pmin and all-gather OR, (P - 1) * 4 W bytes a rank.  The port's words
    are uint32 patterns, so ``max`` and ``min`` run on uint32 words with
    bit 31 set (the reference's on uint32)."""
    rng = np.random.default_rng(len(op))
    x = (rng.integers(-1000, 1000, size=(8, 24)).astype(np.int32) if op == "add"
         else _bitmaps(8, 20, seed=9, nw=24))
    if op == "min":
        want = _ref_run(lambda v: jax.lax.pmin(v, "data"), x)
    else:
        want = _ref_run(lambda v: ref_coll.xla_allreduce(v, "data", op=op), x)
    comm = collectives.Communicator(8, "cpu")
    got = collectives.xla_allreduce(torch.from_numpy(x) if op == "add" else _t(x), comm,
                                    op=op)
    np.testing.assert_array_equal(got.numpy() if op == "add" else _u32(got), want)
    assert comm.bytes_sent.tolist() == [7 * 24 * 4] * 8
    with pytest.raises(ValueError):
        collectives.xla_allreduce(got, comm, op="xor")


# --- BFS end to end -------------------------------------------------------------


GRAPHS = {
    "kron10": lambda gen: gen.kronecker(10, 8, seed=1),
    "torus20": lambda gen: gen.torus_2d(20),
    "path1k": lambda gen: gen.path_graph(1000),
    "star": lambda gen: gen.star_graph(500),
}


def _parts(make, p=8):
    rpg = ref_part.partition_1d(make(ref_gen), p)
    return rpg, partition.from_reference({k: getattr(rpg, k) for k in partition.SCALARS},
                                         rpg.arrays())


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("sync", ["sparse", "adaptive"])
def test_bfs_sparse_sync_matches_reference(mesh8, name, sync):
    rpg, tpg = _parts(GRAPHS[name])
    cfg = ref_bfs.BFSConfig(axes=("data",), sync=sync, fanout=2)
    want = ref_bfs.distributed_bfs(rpg, mesh8, 3, cfg)
    for use_kernels in (False, True):
        got = bfs.distributed_bfs(tpg, 3, bfs.BFSConfig(sync=sync, fanout=2,
                                                        use_kernels=use_kernels),
                                  device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("name", ["torus64", "path8k"])
def test_bfs_adaptive_bench_pathologies(name):
    """The high-diameter families where almost every level is sparse: the
    adaptive sync matches the sequential reference exactly."""
    g = (ref_gen.torus_2d(64) if name == "torus64" else ref_gen.path_graph(8192))
    _, tpg = _parts(lambda gen: g)
    root = int(ref_csr.largest_component_root(g, np.random.default_rng(0)))
    d, levels, _ = bfs.distributed_bfs(tpg, root, bfs.BFSConfig(sync="adaptive", fanout=2),
                                       device="cpu")
    np.testing.assert_array_equal(d, ref_bfs.bfs_reference(g, root))
    assert levels > 60


@pytest.mark.parametrize("p", [2, 4, 8])
def test_bfs_adaptive_partition_invariance(p):
    g = ref_gen.kronecker(10, 8, seed=1)
    _, tpg = _parts(lambda gen: g, p)
    cfg = bfs.BFSConfig(sync="adaptive", fanout=4, sparse_capacity=64)
    d, _, _ = bfs.distributed_bfs(tpg, 11, cfg, device="cpu")
    np.testing.assert_array_equal(d, ref_bfs.bfs_reference(g, 11), err_msg=f"P={p}")


def test_resolved_capacity_matches_reference():
    for cap in (0, 5, 100):
        for nw in (10, 128, 4096, 1 << 16):
            kw = dict(sparse_capacity=cap, density_threshold=0.01)
            assert bfs.BFSConfig(**kw).resolved_capacity(nw) == \
                ref_bfs.BFSConfig(**kw).resolved_capacity(nw)
    fields = {f.name for f in dataclasses.fields(bfs.BFSConfig)}
    assert {"sparse_capacity", "density_threshold"} <= fields
