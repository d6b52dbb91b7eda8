"""PyTorch port, frontier words: int32-stored bitmaps equal the JAX
package's uint32 bitmaps bit for bit, bit 31 included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as ref_fr
from repro_torch.core import frontier as fr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, *shape):
    """Random uint32 words (about half with bit 31 set) plus the edge cases."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    edge = np.array([0x80000000, 0xFFFFFFFF, 0, 0x7FFFFFFF], np.uint32)
    flat[: min(4, flat.size)] = edge[: flat.size]
    return w


def _t(words_u32):
    return torch.from_numpy(words_u32.view(np.int32).copy())


def _u32(t):
    return t.view(torch.uint32).numpy() if t.dtype == torch.int32 else t.numpy()


@pytest.mark.parametrize("w", [1, 4, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_match_reference(w, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=w * 32).astype(bool)
    bits[31] = True  # the sign bit of word 0
    packed = fr.pack(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(packed), np.asarray(ref_fr.pack(jnp.asarray(bits))))
    words = _words(rng, w)
    np.testing.assert_array_equal(fr.unpack(_t(words)).numpy(),
                                  np.asarray(ref_fr.unpack(jnp.asarray(words))))
    np.testing.assert_array_equal(fr.unpack(packed).numpy(), bits)


def test_pack_rejects_ragged_bits():
    with pytest.raises(ValueError):
        fr.pack(torch.zeros(40, dtype=torch.bool))


@pytest.mark.parametrize("p,w,e", [(1, 8, 100), (3, 16, 257), (4, 128, 1000)])
def test_get_bits_matches_reference_per_rank(p, w, e):
    rng = np.random.default_rng(p)
    words = _words(rng, p, w)
    idx = rng.integers(0, w * 32, size=(p, e)).astype(np.int32)
    idx[:, :4] = [31, 63, 0, w * 32 - 1]  # bit 31 and the ends
    got = fr.get_bits(_t(words), torch.from_numpy(idx)).numpy()
    for r in range(p):
        want = ref_fr.get_bits(jnp.asarray(words[r]), jnp.asarray(idx[r]))
        np.testing.assert_array_equal(got[r], np.asarray(want), err_msg=f"rank {r}")


@pytest.mark.parametrize("idx", [0, 5, 31, 32, 63, 255])
def test_set_bit_matches_reference(idx):
    rng = np.random.default_rng(idx)
    words = _words(rng, 8)
    words[idx >> 5] &= ~np.uint32(1 << (idx & 31))
    got = fr.set_bit(_t(np.stack([words, words])), idx)
    want = np.asarray(ref_fr.set_bit(jnp.asarray(words), idx))
    for row in _u32(got):
        np.testing.assert_array_equal(row, want)


def test_set_bit_rejects_out_of_range():
    with pytest.raises(IndexError):
        fr.set_bit(torch.zeros(2, dtype=torch.int32), 64)


@pytest.mark.parametrize("shape", [(1,), (64,), (3, 50)])
def test_popcount_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    words = _words(rng, *shape)
    want = int(ref_fr.popcount(jnp.asarray(words.reshape(-1))))
    assert int(fr.popcount(_t(words))) == want
    for row in words.reshape(-1, shape[-1]):
        assert int(fr.popcount(_t(row))) == int(ref_fr.popcount(jnp.asarray(row)))


@pytest.mark.parametrize("p,n_words,e", [(1, 4, 50), (2, 8, 300), (5, 3, 64)])
def test_scatter_or_matches_reference_per_rank(p, n_words, e):
    rng = np.random.default_rng(e)
    idx = rng.integers(0, n_words * 32, size=(p, e)).astype(np.int32)
    idx[:, :3] = [31, 31, n_words * 32 - 1]  # duplicates and bit 31
    active = rng.integers(0, 2, size=(p, e)).astype(bool)
    active[:, 0] = True
    got = _u32(fr.scatter_or(n_words, torch.from_numpy(idx), torch.from_numpy(active)))
    for r in range(p):
        want = ref_fr.scatter_or(n_words, jnp.asarray(idx[r]), jnp.asarray(active[r]))
        np.testing.assert_array_equal(got[r], np.asarray(want), err_msg=f"rank {r}")


def test_scatter_or_drops_out_of_range():
    idx = torch.tensor([3, 64, -1, 40], dtype=torch.int32)
    out = fr.scatter_or(2, idx, torch.ones(4, dtype=torch.bool))
    assert _u32(out).tolist() == [1 << 3, 1 << 8]
