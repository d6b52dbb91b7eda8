"""PyTorch port, LM building blocks: norms, RoPE, attention (global, windowed,
chunked, decode, ring) and the MLPs against the JAX package on the same
seeded inputs and weights, on the CPU in float32.

Tolerance: atol = rtol = 1e-5 for the blocks (the same float32 math in both
packages; only the order of a product's sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import api, layers
from test_torch_lm_common import TOL, assert_close, jtree, rand_tree, reduced, x_of


# ---------------------------------------------------------------------------
# norms, RoPE, MLP
# ---------------------------------------------------------------------------


def test_rmsnorm_and_layernorms():
    x, jx, tx = x_of((2, 5, 64))
    s = np.random.default_rng(2).normal(size=64).astype(np.float32)
    b = np.random.default_rng(3).normal(size=64).astype(np.float32)
    ts, tb = torch.from_numpy(s), torch.from_numpy(b)
    assert_close(layers.rmsnorm(tx, ts), ref_layers.rmsnorm(jx, jnp.asarray(s)), **TOL)
    assert_close(layers.rmsnorm(tx, None), ref_layers.rmsnorm(jx, None), **TOL)
    assert_close(layers.layernorm(tx, ts, tb),
                 ref_layers.layernorm(jx, jnp.asarray(s), jnp.asarray(b)), **TOL)
    assert_close(layers.layernorm(tx), ref_layers.layernorm(jx), **TOL)  # OLMo's


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
def test_apply_norm_by_config(norm):
    ref_cfg, cfg = reduced("olmo-1b", norm=norm)
    prm = rand_tree(layers.norm_defs(cfg), 4)
    mod = api.load_reference(layers.Norm(cfg, "cpu"), prm)
    x, jx, tx = x_of((2, 3, cfg.d_model))
    assert_close(mod(tx), ref_layers.apply_norm(ref_cfg, jtree(prm), jx), **TOL)


def test_rope():
    x, jx, tx = x_of((2, 7, 4, 32))
    pos = np.array([[0, 1, 2, 5, 100, 4095, 30000]], np.int32)
    for theta in (10_000.0, 1_000_000.0):
        assert_close(layers.rope(tx, torch.from_numpy(pos), theta),
                     ref_layers.rope(jx, jnp.asarray(pos), theta), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-medium"])
def test_mlp(arch):
    """SwiGLU, and whisper's GELU (the tanh approximation, as jax.nn.gelu)."""
    ref_cfg, cfg = reduced(arch)
    prm = rand_tree(layers.mlp_defs(cfg), 5)
    mod = api.load_reference(layers.MLP(cfg, "cpu"), prm)
    x, jx, tx = x_of((2, 6, cfg.d_model))
    assert ("wg" in prm) == (cfg.family != "audio")
    assert_close(layers.mlp(cfg, mod, tx), ref_layers.mlp(ref_cfg, jtree(prm), jx), **TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_setup(arch="qwen3-1.7b", seed=6, **changes):
    ref_cfg, cfg = reduced(arch, **changes)
    prm = rand_tree(layers.attn_defs(cfg), seed)
    return ref_cfg, cfg, jtree(prm), api.load_reference(layers.Attention(cfg, "cpu"), prm)


@pytest.mark.parametrize("l, window", [(24, None), (24, 16), (24, 64), (4096, 16),
                                       (3136, None)])
def test_self_attention(l, window):
    """Global, windowed (sliced when the window is under the length), and the
    query-chunked plans: 4096 in chunks of 1024 (window 16 slices 1040 keys
    a chunk), 3136 in chunks of 64."""
    ref_cfg, cfg, jp, mod = attn_setup()
    assert layers.attn_chunking(cfg, l) == ref_layers.attn_chunking(ref_cfg, l)
    x, jx, tx = x_of((1 if l > 2048 else 2, l, cfg.d_model))
    y, (k, v) = layers.self_attention(cfg, mod, tx, window=window)
    ry, (rk, rv) = ref_layers.self_attention(ref_cfg, jp, jx, window=window)
    assert_close(y, ry, **TOL)
    assert_close(k, rk, **TOL)
    assert_close(v, rv, **TOL)


def test_self_attention_bidirectional():
    ref_cfg, cfg, jp, mod = attn_setup("whisper-medium")
    x, jx, tx = x_of((2, 9, cfg.d_model))
    y, _ = layers.self_attention(cfg, mod, tx, causal=False)
    ry, _ = ref_layers.self_attention(ref_cfg, jp, jx, causal=False)
    assert_close(y, ry, **TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(window):
    """One token against a cache of 12 with 7 filled; the new k/v written at
    pos in place, equal to the reference's updated cache."""
    ref_cfg, cfg, jp, mod = attn_setup()
    x, jx, tx = x_of((2, 1, cfg.d_model))
    ck = np.random.default_rng(7).normal(size=(2, 12, cfg.n_kv_heads, 32)).astype(np.float32)
    cv = np.random.default_rng(8).normal(size=ck.shape).astype(np.float32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y, k2, v2 = layers.decode_attention(cfg, mod, tx, tk, tv, 7, window=window)
    ry, rk, rv = ref_layers.decode_attention(ref_cfg, jp, jx, jnp.asarray(ck),
                                             jnp.asarray(cv), jnp.int32(7), window=window)
    assert k2 is tk and v2 is tv
    assert_close(y, ry, **TOL)
    assert_close(tk, rk, **TOL)
    assert_close(tv, rv, **TOL)


@pytest.mark.parametrize("pos", [3, 8, 21])
def test_decode_attention_ring_and_to_ring(pos):
    """to_ring on a prefill cache, then one ring decode step (before, at and
    past the window's wrap)."""
    w = 8
    ref_cfg, cfg, jp, mod = attn_setup()
    full = np.random.default_rng(9).normal(size=(2, 24, cfg.n_kv_heads, 32)).astype(np.float32)
    ring = layers.to_ring(torch.from_numpy(full), pos, w)
    rring = ref_layers.to_ring(jnp.asarray(full), pos, w)
    assert_close(ring, rring, atol=0, rtol=0)
    x, jx, tx = x_of((2, 1, cfg.d_model))
    tk, tv = ring.clone(), ring.clone() * 0.5
    y, _, _ = layers.decode_attention_ring(cfg, mod, tx, tk, tv, pos)
    ry, rk, rv = ref_layers.decode_attention_ring(ref_cfg, jp, jx, rring, rring * 0.5,
                                                  jnp.int32(pos))
    assert_close(y, ry, **TOL)
    assert_close(tk, rk, **TOL)
    assert_close(tv, rv, **TOL)


def test_cross_attention():
    ref_cfg, cfg, jp, mod = attn_setup("qwen3-1.7b")  # qk-norm on the query and keys
    _, jenc, tenc = x_of((2, 11, cfg.d_model), 10)
    x, jx, tx = x_of((2, 5, cfg.d_model))
    kv = layers.cross_kv(cfg, mod, tenc)
    rkv = ref_layers.cross_kv(ref_cfg, jp, jenc)
    for a, b in zip(kv, rkv):
        assert_close(a, b, **TOL)
    assert_close(layers.cross_attention(cfg, mod, tx, kv),
                 ref_layers.cross_attention(ref_cfg, jp, jx, rkv), **TOL)
