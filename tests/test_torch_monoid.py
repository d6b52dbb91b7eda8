"""PyTorch port, merge monoids: OR_U32, MIN_U32, MAX_U32, ADD_U32 and
ADD_F32 keep the JAX package's laws, construction checks, idempotence/delta
dichotomy and identity padding, and their butterfly reductions (dense and
sparse) equal the reference's collectives, its host oracles and the byte
model exactly; MIN and MAX order int32 words as uint32 (bit 31 and the
``0xFFFFFFFF`` sentinel included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import butterfly as ref_bf
from repro.core import collectives as ref_coll
from repro.core import frontier as ref_fr
from repro.core import monoid as ref_mono
from repro_torch.core import butterfly, collectives, monoid as mono
from repro_torch.core import frontier as fr

NW = 64
_OPS = {
    "or": (mono.OR_U32, ref_mono.OR_U32, np.bitwise_or),
    "min": (mono.MIN_U32, ref_mono.MIN_U32, np.minimum),
    "max": (mono.MAX_U32, ref_mono.MAX_U32, np.maximum),
    "add_u32": (mono.ADD_U32, ref_mono.ADD_U32, np.add),
}


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


def _rand(shape, seed, hi=2**32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _ref_run(fn, x):
    sm = jax.shard_map(fn, mesh=jax.make_mesh((x.shape[0],), ("data",),
                                              axis_types=(jax.sharding.AxisType.Auto,)),
                       in_specs=P("data"), out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(sm)(x))


@pytest.mark.parametrize("name", sorted(_OPS))
@pytest.mark.parametrize("seed", [0, 7])
def test_monoid_laws_match_reference(name, seed):
    m, rm, _ = _OPS[name]
    a, b, c = (_rand(8, seed + i) for i in range(3))
    a[0], b[0] = 0x80000000, 0xFFFFFFFF  # bit 31 and wrap-around
    ta, tb, tc = _t(a), _t(b), _t(c)
    np.testing.assert_array_equal(_u32(m.combine(ta, tb)),
                                  np.asarray(rm.combine(jnp.asarray(a), jnp.asarray(b))))
    assert torch.equal(m.combine(m.combine(ta, tb), tc), m.combine(ta, m.combine(tb, tc)))
    assert torch.equal(m.combine(ta, tb), m.combine(tb, ta))
    assert torch.equal(m.combine(ta, m.full(ta.shape, ta.dtype)), ta)
    assert torch.equal(m.combine(ta, ta), ta) == m.idempotent
    assert (m.name, m.identity, m.idempotent, m.sparse_mode) == \
        (rm.name, rm.identity, rm.idempotent, rm.sparse_mode)


@pytest.mark.parametrize("name", sorted(_OPS))
@pytest.mark.parametrize("p,fanout", [(1, 2), (2, 1), (4, 4), (8, 2), (8, 4)])
def test_butterfly_reduce_matches_host_fold(name, p, fanout):
    m, _, host_op = _OPS[name]
    x = _rand((p, NW), p * 31 + fanout)  # add wraps: the uint32 sum mod 2^32
    want = host_op.reduce(x.astype(np.uint64), axis=0).astype(np.uint32)
    comm = collectives.Communicator(p, "cpu")
    got = collectives.butterfly_reduce(_t(x), comm, m, fanout=fanout)
    for r in range(p):
        np.testing.assert_array_equal(_u32(got)[r], want, err_msg=f"rank {r}")
    assert comm.bytes_sent.tolist() == [butterfly.bytes_per_node_allreduce(p, fanout, NW * 4)] * p


@pytest.mark.parametrize("name", sorted(_OPS))
def test_butterfly_reduce_matches_jax_collective(mesh8, name):
    m, rm, _ = _OPS[name]
    x = _rand((8, NW), 11)
    want = _ref_run(lambda v: ref_coll.butterfly_reduce(v, "data", rm, fanout=4), x)
    got = collectives.butterfly_reduce(_t(x), collectives.Communicator(8, "cpu"), m,
                                       fanout=4)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("p,fanout,n_changed", [(2, 1, 3), (4, 4, 12), (8, 2, 5),
                                                (8, 4, 0), (4, 2, 40)])
def test_sparse_or_remerge_matches_dense_and_oracle(p, fanout, n_changed):
    """Changed-vs-ref remerge over OR from a shared non-identity reference;
    40 changed words overflow the capacity of 16 and take the dense path."""
    rng = np.random.default_rng(p * 17 + fanout)
    ref = _rand(NW, p)
    x = np.tile(ref, (p, 1))
    for r in range(p):
        ii = rng.choice(NW, size=n_changed, replace=False)
        x[r, ii] = _rand(n_changed, r + 100) | ref[ii]  # improvements over ref
    comm = collectives.Communicator(p, "cpu")
    got = collectives.butterfly_reduce_sparse(_t(x), comm, mono.OR_U32, fanout=fanout,
                                              capacity=16, ref=_t(ref))
    want = np.bitwise_or.reduce(x, axis=0)
    sim, stats = ref_bf.simulate_reduce_sparse(list(x), fanout, 16, combine=np.bitwise_or,
                                               identity=0, ref=ref)
    assert stats["mode"] == ("sparse" if n_changed <= 16 else "dense")
    for r in range(p):
        np.testing.assert_array_equal(_u32(got)[r], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(sim[r], want)
    assert comm.bytes_sent.tolist() == [stats["bytes_per_node"]] * p


@pytest.mark.parametrize("fanout", [1, 4])
def test_sparse_add_delta_matches_jax_collective(mesh8, fanout):
    """Delta mode (ref=None) over the non-idempotent ADD_U32: exact against
    the reference's sparse collective and the wrapping dense sum."""
    rng = np.random.default_rng(fanout)
    x = np.zeros((8, NW), np.uint32)
    for r in range(8):
        ii = rng.choice(NW, size=3, replace=False)
        x[r, ii] = _rand(3, r) | 1
    x[0, 0] = 0xFFFFFFFF  # wraps when another rank adds to word 0
    x[1, 0] = 5
    want = _ref_run(lambda v: ref_coll.butterfly_reduce_sparse(
        v[0], "data", ref_mono.ADD_U32, fanout=fanout, capacity=8)[None], x)
    comm = collectives.Communicator(8, "cpu")
    got = collectives.butterfly_reduce_sparse(_t(x), comm, mono.ADD_U32,
                                              fanout=fanout, capacity=8)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(got)[0], np.add.reduce(x, axis=0, dtype=np.uint32))
    assert comm.bytes_sent.tolist() == [butterfly.bytes_per_node_sparse(8, fanout, 8, NW)] * 8


@pytest.mark.parametrize("capacity", [1, 16, NW])
def test_identity_padding_matches_reference_and_is_noop(capacity):
    """compact_changed -> scatter_combine round-trips exactly as the
    reference's: an unchanged buffer gives only (0, identity) pads, and
    re-combining a compaction into its own buffer is a no-op."""
    m, rm = mono.OR_U32, ref_mono.OR_U32
    words = _rand(NW, capacity)
    words[0] = 0x80000001
    for ref in (words, np.zeros(NW, np.uint32)):
        got = fr.compact_changed(_t(words), _t(ref), capacity, m)
        want = ref_fr.compact_changed(jnp.asarray(words), jnp.asarray(ref), capacity, rm)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_u32(got[1]), np.asarray(want[1]))
        assert (int(got[2]), bool(got[3])) == (int(want[2]), bool(want[3]))
        back = fr.scatter_combine(_t(words), got[0], got[1], m)
        np.testing.assert_array_equal(_u32(back), words)
    idx, vals, count, _ = fr.compact_changed(_t(words), _t(words), capacity, m)
    assert int(count) == 0 and not idx.any() and not vals.any()


def test_or_scatter_keeps_bit31_at_word0_beside_pads():
    """A true OR scatter: the (0, 0) pads cannot overwrite a real word at
    index 0 whose bit 31 is set (a signed max would pick 0 over it)."""
    idx = torch.tensor([[0, 3, 0, 0]], dtype=torch.int32)
    vals = _t(np.array([[0x80000000, 7, 0, 0]], np.uint32))
    for buf in (np.zeros((1, 4), np.uint32), np.array([[1, 2, 0, 8]], np.uint32)):
        got = mono.OR_U32.scatter_into(_t(buf), idx, vals)
        np.testing.assert_array_equal(_u32(got), buf | np.array([[0x80000000, 0, 0, 7]],
                                                                 np.uint32))
    added = mono.ADD_U32.scatter_into(torch.zeros((1, 4), dtype=torch.int32),
                                      torch.tensor([[2, 2, 0]]), _t(np.array([[3, 4, 0]])))
    assert added.tolist() == [[0, 0, 7, 0]]  # duplicates add


def test_sparse_dichotomy_rejects_non_idempotent_remerge():
    x = torch.zeros((2, 8), dtype=torch.int32)
    comm = collectives.Communicator(2, "cpu")
    for fn in (collectives.butterfly_reduce_sparse, collectives.butterfly_reduce_adaptive):
        with pytest.raises(mono.MonoidContractError, match="DELTA"):
            fn(x, comm, mono.ADD_U32, ref=torch.ones(8, dtype=torch.int32))
        with pytest.raises(ref_mono.MonoidContractError, match="DELTA"):
            (ref_coll.butterfly_reduce_sparse if fn is collectives.butterfly_reduce_sparse
             else ref_coll.butterfly_reduce_adaptive)(
                jnp.zeros(8, jnp.uint32), "data", ref_mono.ADD_U32,
                ref=jnp.ones(8, jnp.uint32))
    assert comm.bytes_sent.tolist() == [0, 0]


def test_monoid_validates_idempotence_flag_at_construction():
    with pytest.raises(mono.MonoidContractError) as ei:
        mono.Monoid("bad_add", 0.0, torch.add, "add", idempotent=True)
    assert (ei.value.monoid, ei.value.flag) == ("bad_add", True)
    assert ei.value.counterexample is not None
    with pytest.raises(mono.MonoidContractError) as ei:
        mono.Monoid("bad_or", 0, torch.bitwise_or, "or", idempotent=False)
    assert ei.value.flag is False
    with pytest.raises(mono.MonoidContractError, match="unit"):
        mono.Monoid("bad_id", 7, torch.bitwise_or, "or", idempotent=True)
    with pytest.raises(ValueError, match="scatter"):
        mono.Monoid("bad_scatter", 0, torch.bitwise_or, "max", idempotent=True)


def test_sparse_mode_and_registry():
    assert mono.OR_U32.sparse_mode == mono.SPARSE_REMERGE == ref_mono.SPARSE_REMERGE
    assert mono.ADD_U32.sparse_mode == mono.SPARSE_DELTA == ref_mono.SPARSE_DELTA
    assert mono.by_name("or") is mono.OR_U32
    assert mono.by_name("add_u32") is mono.ADD_U32
    with pytest.raises(ValueError, match="unknown monoid"):
        mono.by_name("xor")
    for name, m in (("min", mono.MIN_U32), ("max", mono.MAX_U32), ("add", mono.ADD_F32)):
        rm = ref_mono.by_name(name)
        assert mono.by_name(name) is m
        assert (m.name, m.identity, m.idempotent, m.sparse_mode) == \
            (rm.name, rm.identity, rm.idempotent, rm.sparse_mode)


@pytest.mark.parametrize("density", ["low", "high"])
def test_adaptive_reduce_dispatches_both_ways(density):
    """ADD_U32 in delta mode: two changed words per rank ship sparse,
    every word changed ships dense; both equal the fold, and the bytes
    name the branch taken."""
    p = 4
    if density == "low":
        x = np.zeros((p, NW), np.uint32)
        for r in range(p):
            x[r, 2 * r], x[r, 2 * r + 1] = r + 1, r + 7
    else:
        x = np.arange(p * NW, dtype=np.uint32).reshape(p, NW) + 1
    comm = collectives.Communicator(p, "cpu")
    got = collectives.butterfly_reduce_adaptive(_t(x), comm, mono.ADD_U32, capacity=8,
                                                density_threshold=0.25)
    for r in range(p):
        np.testing.assert_array_equal(_u32(got)[r], np.add.reduce(x, axis=0, dtype=np.uint32))
    want = (butterfly.bytes_per_node_sparse(p, 2, 8, NW) if density == "low"
            else butterfly.bytes_per_node_allreduce(p, 2, NW * 4))
    assert comm.bytes_sent.tolist() == [want] * p


# --- MIN_U32 / MAX_U32: uint32 order on int32 words --------------------------


def test_min_max_order_words_as_uint32():
    """The unreached sentinel 0xFFFFFFFF (-1 as int32) is the LARGEST word
    and bit-31 words sit above every word without it: a signed compare
    fails each of these."""
    a = _t(np.array([0xFFFFFFFF, 0x80000000, 5, 0x7FFFFFFF], np.uint32))
    b = _t(np.array([5, 7, 0xFFFFFFFF, 0x80000000], np.uint32))
    assert _u32(mono.MIN_U32.combine(a, b)).tolist() == [5, 7, 5, 0x7FFFFFFF]
    assert _u32(mono.MAX_U32.combine(a, b)).tolist() == [0xFFFFFFFF, 0x80000000,
                                                         0xFFFFFFFF, 0x80000000]
    assert mono.ult(a, b).tolist() == [False, False, True, True]
    f = torch.tensor([-1.0, 2.0])
    assert mono.umin(f, -f).tolist() == [-1.0, -2.0]  # floats compare as floats


@pytest.mark.parametrize("name", ["min", "max"])
@pytest.mark.parametrize("seed", [0, 5])
def test_min_max_scatter_into_matches_reference(name, seed):
    """Duplicates combine in uint32 order, bit 31 and the sentinel
    included, as the reference's scatter-min/max on uint32."""
    m, rm, _ = _OPS[name]
    rng = np.random.default_rng(seed)
    buf = _rand((2, 16), seed)
    buf[:, 0] = 0xFFFFFFFF
    idx = rng.integers(0, 16, size=(2, 40)).astype(np.int32)
    vals = _rand((2, 40), seed + 1)
    vals[:, :3] = [0x80000000, 0xFFFFFFFF, 1]
    idx[:, :3] = 0
    got = m.scatter_into(_t(buf), torch.from_numpy(idx), _t(vals))
    for r in range(2):
        want = rm.scatter_into(jnp.asarray(buf[r]), jnp.asarray(idx[r]),
                               jnp.asarray(vals[r]))
        np.testing.assert_array_equal(_u32(got)[r], np.asarray(want))


def test_construction_refuses_a_signed_min_and_a_mismatched_scatter():
    """The probe words carry bit 31 and 0xFFFFFFFF: a signed ``minimum``
    makes the identity no unit, and a scatter that disagrees with combine
    is refused."""
    with pytest.raises(mono.MonoidContractError, match="unit") as ei:
        mono.Monoid("signed_min", 0xFFFFFFFF, torch.minimum, "min", idempotent=True)
    assert ei.value.counterexample is not None
    with pytest.raises(mono.MonoidContractError, match="scatter 'max'"):
        mono.Monoid("min_max", 0xFFFFFFFF, mono.umin, "max", idempotent=True)
    with pytest.raises(mono.MonoidContractError, match="scatter 'min'"):
        mono.Monoid("signed_scatter", 0, mono.umax, "min", idempotent=True)


@pytest.mark.parametrize("p,fanout,n_changed", [(2, 1, 3), (8, 4, 5), (4, 2, 40)])
def test_sparse_min_remerge_matches_dense_and_jax(mesh8, p, fanout, n_changed):
    """SSSP's exchange: MIN_U32 remerge against a shared reference holding
    the sentinel and bit-31 distances; 40 changed words overflow the
    capacity of 16 and take the dense path."""
    rng = np.random.default_rng(p * 3 + fanout)
    ref = _rand(NW, p)
    ref[::3] = 0xFFFFFFFF
    x = np.tile(ref, (p, 1))
    for r in range(p):
        ii = rng.choice(NW, size=n_changed, replace=False)
        x[r, ii] = np.minimum(_rand(n_changed, r + 50), ref[ii])  # improvements
    comm = collectives.Communicator(p, "cpu")
    got = collectives.butterfly_reduce_sparse(_t(x), comm, mono.MIN_U32, fanout=fanout,
                                              capacity=16, ref=_t(ref))
    want = np.minimum.reduce(x, axis=0)
    sim, stats = ref_bf.simulate_reduce_sparse(list(x), fanout, 16, combine=np.minimum,
                                               identity=0xFFFFFFFF, ref=ref)
    for r in range(p):
        np.testing.assert_array_equal(_u32(got)[r], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(sim[r], want)
    assert comm.bytes_sent.tolist() == [stats["bytes_per_node"]] * p
    if p == 8:
        jref = _ref_run(lambda v: ref_coll.butterfly_reduce_sparse(
            v[0], "data", ref_mono.MIN_U32, fanout=fanout, capacity=16,
            ref=jnp.asarray(ref))[None], x)
        np.testing.assert_array_equal(_u32(got), jref)


@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("n_changed", [2, 30])
def test_sparse_add_f32_delta_equals_dense_bit_for_bit(mesh8, fanout, n_changed):
    """PageRank's exchange: each rank's own float32 contributions against
    ref=None; the sparse wire (float bits shipped as int32 words, 8 bytes a
    pair) sums in the dense butterfly's order, so the result is bit-equal;
    30 changed words overflow the capacity and fall back to the dense
    path."""
    rng = np.random.default_rng(fanout * 7 + n_changed)
    x = np.zeros((8, NW), np.float32)
    for r in range(8):
        ii = rng.choice(NW, size=n_changed, replace=False)
        x[r, ii] = rng.random(n_changed).astype(np.float32) / 3
    dense_comm = collectives.Communicator(8, "cpu")
    dense = collectives.butterfly_reduce(torch.from_numpy(x), dense_comm, mono.ADD_F32,
                                         fanout=fanout)
    comm = collectives.Communicator(8, "cpu")
    got = collectives.butterfly_reduce_sparse(torch.from_numpy(x), comm, mono.ADD_F32,
                                              fanout=fanout, capacity=16)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
    want = (butterfly.bytes_per_node_sparse(8, fanout, 16, NW) if n_changed <= 16
            else dense_comm.bytes_sent[0])
    assert comm.bytes_sent.tolist() == [want] * 8
    jref = _ref_run(lambda v: ref_coll.butterfly_reduce_sparse(
        v[0], "data", ref_mono.ADD_F32, fanout=fanout, capacity=16)[None], x)
    np.testing.assert_allclose(got.numpy(), jref, rtol=1e-6)
    with pytest.raises(mono.MonoidContractError, match="DELTA"):
        collectives.butterfly_reduce_adaptive(torch.from_numpy(x), comm, mono.ADD_F32,
                                              ref=torch.zeros(NW))


@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_all_to_all_merge_takes_the_monoid_op(mesh8, op):
    x = _rand((8, NW), 21)
    x[0, 0], x[1, 0] = 0xFFFFFFFF, 0x80000000
    m = {"min": mono.MIN_U32, "max": mono.MAX_U32, "add": mono.ADD_U32}[op]
    rop = {"min": jnp.minimum, "max": jnp.maximum, "add": "add"}[op]
    comm = collectives.Communicator(8, "cpu")
    got = collectives.all_to_all_merge(_t(x), comm, op=m.combine)
    np.testing.assert_array_equal(_u32(got), _ref_run(
        lambda v: ref_coll.all_to_all_merge(v, "data", op=rop), x))
    assert torch.equal(collectives.all_to_all_merge(_t(x), comm, op=op), got)


def test_rabenseifner_adds_float32(mesh8):
    """BC's ADD merge on the Rabenseifner wiring, float32 (zero pads)."""
    x = np.random.default_rng(3).random((8, 50)).astype(np.float32)
    got = collectives.butterfly_allreduce_rabenseifner(
        torch.from_numpy(x), collectives.Communicator(8, "cpu"), fanout=4, op="add")
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(x.sum(0), x.shape), rtol=1e-6)
