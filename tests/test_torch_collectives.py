"""PyTorch port, frontier merges over simulated ranks: the butterfly OR
equals the JAX package's host simulator and its shard_map collective, and
the per-rank byte counter equals the analytic byte model exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import butterfly as ref_bf
from repro.core import collectives as ref_coll
from repro_torch.core import butterfly, collectives

FANOUTS = (1, 2, 3, 4, 8)
W = 6  # words per rank buffer


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitmaps(p, seed=0):
    rng = np.random.default_rng(seed + p)
    x = rng.integers(0, 2**32, size=(p, W), dtype=np.uint32)
    x[:, 0] = np.uint32(1) << (np.arange(p, dtype=np.uint32) % 32)  # one bit per rank
    x[0, 1] = 0x80000000
    return x


def _t(x):
    return torch.from_numpy(x.view(np.int32).copy())


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("p", range(1, 17))
def test_butterfly_or_matches_simulator_and_byte_model(p, fanout):
    x = _bitmaps(p)
    want = ref_bf.simulate_allreduce(list(x), fanout, op=np.bitwise_or)
    for use_kernels in (True, False):
        comm = collectives.Communicator(p, "cpu")
        got = collectives.butterfly_or(_t(x), comm, fanout=fanout,
                                       use_kernels=use_kernels)
        np.testing.assert_array_equal(got.view(torch.uint32).numpy(), np.stack(want))
        assert np.all(got.view(torch.uint32).numpy() == np.bitwise_or.reduce(x, 0))
        assert comm.bytes_sent.tolist() == [
            ref_bf.bytes_per_node_allreduce(p, fanout, W * 4)] * p


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8, 16])
def test_all_to_all_merge_matches_or_and_bytes(p):
    x = _bitmaps(p, seed=3)
    comm = collectives.Communicator(p, "cpu")
    got = collectives.all_to_all_merge(_t(x), comm)
    assert np.all(got.view(torch.uint32).numpy() == np.bitwise_or.reduce(x, 0))
    assert comm.bytes_sent.tolist() == [(p - 1) * W * 4] * p


@pytest.mark.parametrize("fanout", [1, 2, 4])
def test_butterfly_or_matches_jax_collective(mesh8, fanout):
    x = _bitmaps(8, seed=fanout)
    sm = jax.shard_map(lambda v: ref_coll.butterfly_or(v, "data", fanout=fanout),
                       mesh=mesh8, in_specs=P("data"), out_specs=P("data"),
                       check_vma=False)
    want = np.asarray(jax.jit(sm)(x.reshape(8 * W))).reshape(8, W)
    got = collectives.butterfly_or(_t(x), collectives.Communicator(8, "cpu"),
                                   fanout=fanout)
    np.testing.assert_array_equal(got.view(torch.uint32).numpy(), want)


@pytest.mark.parametrize("fanout", FANOUTS)
def test_schedule_copy_matches_reference(fanout):
    for p in range(1, 17):
        assert dataclasses.astuple(butterfly.build_schedule(p, fanout)) == \
            dataclasses.astuple(ref_bf.build_schedule(p, fanout))
        for fn, args in (("digit_plan", ()), ("messages_per_node", ()),
                         ("total_messages", ()),
                         ("bytes_per_node_allreduce", (64,))):
            assert getattr(butterfly, fn)(p, fanout, *args) == \
                getattr(ref_bf, fn)(p, fanout, *args), (fn, p)


def test_ppermute_is_the_wire():
    comm = collectives.Communicator(3, "cpu")
    x = torch.arange(6, dtype=torch.int32).view(3, 2)
    recv = comm.ppermute(x, [2, 0, 1])  # recv[perm[src]] = x[src]
    assert recv.tolist() == [[2, 3], [4, 5], [0, 1]]
    assert comm.bytes_sent.tolist() == [8, 8, 8]
    with pytest.raises(ValueError, match="permutation"):
        comm.ppermute(x, [0, 0, 1])
    with pytest.raises(ValueError, match="ranks"):
        comm.ppermute(x[:2], [1, 0])
