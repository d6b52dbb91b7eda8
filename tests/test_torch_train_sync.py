"""The gradient sync on simulated ranks against the JAX package's on
``mesh8``: ``tree_sync`` by every method and fanout (rtol 1e-5), the bytes
each rank sends equal to the byte model of each method, and the int8 wire
(``tree_sync_int8``): its values within 1e-6 of the reference's, its codes
equal to a numpy oracle's (round half to even), its error within
``depth * max|g| / 127`` and its bytes about a quarter of float32's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import collectives as ref_coll
from repro_torch.core import butterfly, collectives

METHODS = ["xla_psum", "butterfly", "rabenseifner", "all_to_all"]


def tree_of():
    """tests/test_collectives.py::test_tree_sync_methods_agree's tree."""
    return {
        "a": np.random.default_rng(4).normal(size=(8, 7)).astype(np.float32),
        "b": np.random.default_rng(5).normal(size=(8, 3, 2)).astype(np.float32),
    }


def ref_sync(mesh, fn, tree):
    sm = jax.shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                       check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(sm)(tree))


def leaf_bytes(tree, method, fanout, compress=None):
    return sum(collectives.grad_sync_bytes(method, 8, fanout, v[0].size, 4, compress)
               for v in tree.values())


@pytest.mark.parametrize("fanout", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_tree_sync_matches_reference(mesh8, method, fanout):
    tree = tree_of()
    want = ref_sync(mesh8, lambda t: ref_coll.tree_sync(t, ("data",), method=method,
                                                        fanout=fanout), tree)
    comm = collectives.Communicator(8, "cpu")
    got = collectives.tree_sync({k: torch.from_numpy(v) for k, v in tree.items()}, comm,
                                method=method, fanout=fanout)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got[k].numpy()[0], tree[k].mean(0), rtol=1e-5, atol=1e-6)
    assert (comm.bytes_sent == leaf_bytes(tree, method, fanout)).all(), comm.bytes_sent
    # the byte models: full buffer a message, Rabenseifner 2 (P-1)/P of the padded one
    n = sum(v[0].size for v in tree.values())
    expect = {"butterfly": butterfly.messages_per_node(8, fanout) * 4 * n,
              "rabenseifner": 2 * 7 * (8 + 8) // 8 * 4, "all_to_all": 7 * 4 * n,
              "xla_psum": 7 * 4 * n}[method]
    assert comm.bytes_sent[0] == expect


def int8_oracle(x, fanout):
    """The int8-wire butterfly in numpy: every round each rank quantizes its
    float32 accumulator with its own scale, and adds what it receives in the
    round's perm order. -> (result, codes shipped each round)."""
    acc = x.astype(np.float32)
    codes = []
    for rnd in butterfly.build_schedule(8, fanout).rounds:
        scale = np.maximum(np.abs(acc).reshape(8, -1).max(1) / np.float32(127),
                           np.float32(1e-30)).astype(np.float32)
        q = np.clip(np.round(acc / scale[:, None]), -127, 127).astype(np.int8)
        codes.append(q)
        new = acc.copy()
        for perm in rnd.perms:
            src = np.argsort(perm)  # recv[perm[s]] = send[s]
            new = new + q[src].astype(np.float32) * scale[src][:, None]
        acc = new
    return acc, codes


class Recording(collectives.Communicator):
    """A Communicator that keeps every int8 buffer it carries."""

    def __init__(self, *a):
        super().__init__(*a)
        self.int8 = []

    def ppermute(self, x, perm, out=None):
        if x.dtype == torch.int8:
            self.int8.append(x.clone())
        return super().ppermute(x, perm, out)


@pytest.mark.parametrize("fanout", [2, 4])
def test_tree_sync_int8_matches_reference(mesh8, fanout):
    """A code that differed from the reference's would move a value by a
    whole step (``max|acc| / 127``), so values within 1e-6 of the
    reference's show its codes are the port's."""
    x = np.random.default_rng(0).normal(size=(8, 13)).astype(np.float32)
    tree = {"x": x}
    want = ref_sync(mesh8, lambda t: ref_coll.tree_sync_int8(t, ("data",), fanout=fanout),
                    tree)["x"]
    comm = Recording(8, "cpu")
    got = collectives.tree_sync_int8({"x": torch.from_numpy(x)}, comm, fanout=fanout)["x"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    oracle, codes = int8_oracle(x, fanout)
    np.testing.assert_allclose(got.numpy(), oracle / 8, rtol=0, atol=1e-6)
    rounds = butterfly.build_schedule(8, fanout).rounds
    assert len(comm.int8) == sum(len(rnd.perms) for rnd in rounds)
    i = 0
    for rnd, q in zip(rounds, codes):
        for _ in rnd.perms:  # every message of a round ships the same codes
            assert np.array_equal(comm.int8[i].numpy(), q)
            i += 1
    # tests/test_collectives.py's bound: depth * max|acc| / 127 per element
    depth = len(rounds)
    err = np.abs(got.numpy() * 8 - x.sum(0)).max()
    assert err <= depth * np.abs(x).sum(axis=0).max() / 127 + 1e-6
    # one byte an element and a 4-byte scale a message: about a quarter
    assert (comm.bytes_sent == leaf_bytes(tree, "butterfly", fanout, "int8")).all()
    assert comm.bytes_sent[0] == butterfly.messages_per_node(8, fanout) * (13 + 4)
    assert comm.bytes_sent[0] < 0.4 * leaf_bytes(tree, "butterfly", fanout)


def test_quantize_rounds_half_to_even():
    acc = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, scale = collectives.quantize_int8(acc)
    assert float(scale) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]
    q0, s0 = collectives.quantize_int8(torch.zeros(2, 3))
    assert (q0 == 0).all() and (s0 == np.float32(1e-30)).all()


def test_unknown_method_refused():
    with pytest.raises(ValueError, match="grad-sync method"):
        collectives.sync_leaf(torch.zeros(8, 2), collectives.Communicator(8, "cpu"),
                              method="ring")
