"""PyTorch port, the MoE block (routing, dispatch, combine, capacity drops)
and Mamba-2 (chunked SSD, the mixer with its cache, the recurrent decode
step) against the JAX package and the naive recurrence, on the same seeded
inputs and weights, on the CPU in float32.

Tolerance: atol = rtol = 1e-5 (the same float32 math in both packages;
only the order of a product's sums differs); the reference's own 2e-4
against the numpy oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
from repro_torch.dist import sharding
from repro_torch.models import api, mamba2, moe
from test_torch_lm_common import TOL, assert_close, jtree, rand_tree, reduced, x_of


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_setup(arch, **changes):
    ref_cfg, cfg = reduced(arch, **changes)
    prm = rand_tree(moe.moe_defs(cfg), 11)
    return ref_cfg, cfg, prm, api.load_reference(moe.MoE(cfg, "cpu"), prm)


@pytest.mark.parametrize("arch, cf, l", [("qwen3-moe-235b-a22b", None, 16),
                                         ("kimi-k2-1t-a32b", None, 16),
                                         ("qwen3-moe-235b-a22b", 0.25, 64),
                                         ("jamba-v0.1-52b", 1.0, 32)])
def test_moe_block(arch, cf, l):
    """The block and its routing (selected experts, slots, keep mask) equal the
    reference's: dropless (the reduced configs), and dropping at capacity."""
    changes = {} if cf is None else {"capacity_factor": cf}
    ref_cfg, cfg, prm, mod = moe_setup(arch, **changes)
    assert moe.capacity(cfg, l) == ref_moe.capacity(ref_cfg, l)
    x, jx, tx = x_of((2, l, cfg.d_model), 12)
    assert_close(moe.moe_block(cfg, mod, tx), ref_moe.moe_block(ref_cfg, jtree(prm), jx), **TOL)

    probs = jax.nn.softmax(jnp.einsum("bld,de->ble", jx, jnp.asarray(prm["router"])), -1)
    _, rsel = jax.lax.top_k(probs, cfg.experts_per_token)
    _, sel = moe.top_k(torch.softmax(torch.einsum("bld,de->ble", tx, mod.router), -1),
                       cfg.experts_per_token)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(rsel))
    cap = moe.capacity(cfg, l)
    got = moe._route_row(sel.reshape(2, -1), cfg.experts_per_token, cap)
    want = jax.vmap(lambda fe: ref_moe._route_row(fe, cfg.experts_per_token, cap))(
        rsel.reshape(2, -1).astype(jnp.int32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cf == 0.25:
        assert not bool(got[2].all())  # assignments were dropped


def test_top_k_ties_lower_index_first():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    vals, idx = moe.top_k(x, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert idx.tolist() == [[1, 3, 0]]


def test_moe_equals_dense_when_undropped():
    """capacity >= L*k  =>  MoE == explicit per-token weighted expert sum."""
    _, cfg, prm, mod = moe_setup("qwen3-moe-235b-a22b", capacity_factor=100.0)
    x = np.random.default_rng(1).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    got = moe.moe_block(cfg, mod, torch.from_numpy(x)).numpy()
    logits = np.einsum("bld,de->ble", x, prm["router"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sel = np.argsort(-probs, axis=-1, kind="stable")[..., :cfg.experts_per_token]
    w = np.take_along_axis(probs, sel, -1)
    w /= w.sum(-1, keepdims=True)

    def expert(e, xv):
        g = xv @ prm["wg"][e]
        return ((g / (1 + np.exp(-g))) * (xv @ prm["wi"][e])) @ prm["wo"][e]

    want = np.zeros_like(x)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            for k in range(cfg.experts_per_token):
                want[b, t] += w[b, t, k] * expert(sel[b, t, k], x[b, t])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_moe_capacity_drops_tokens():
    _, cfg, prm, mod = moe_setup("qwen3-moe-235b-a22b", capacity_factor=0.25)
    assert moe.capacity(cfg, 64) < 64 * cfg.experts_per_token // cfg.n_experts + 8
    x = np.random.default_rng(1).normal(size=(1, 64, cfg.d_model)).astype(np.float32)
    out = moe.moe_block(cfg, mod, torch.from_numpy(x))
    assert torch.isfinite(out).all()
    # a dropped assignment loses its weight: not the dropless block's result
    _, cfg_all, _, mod_all = moe_setup("qwen3-moe-235b-a22b", capacity_factor=100.0)
    assert not torch.allclose(out, moe.moe_block(cfg_all, mod_all, torch.from_numpy(x)))


def test_moe_rows_route_independently():
    """Routing is per row: a row's output does not depend on its neighbours."""
    _, cfg, _, mod = moe_setup("qwen3-moe-235b-a22b", capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 32, cfg.d_model)).astype(np.float32))
    both = moe.moe_block(cfg, mod, x)
    for r in range(3):
        assert_close(moe.moe_block(cfg, mod, x[r:r + 1])[0], both[r], atol=1e-6, rtol=1e-6)


def test_aux_load_loss():
    ref_cfg, cfg, prm, mod = moe_setup("qwen3-moe-235b-a22b")
    x, jx, tx = x_of((2, 16, cfg.d_model), 13)
    assert_close(moe.aux_load_loss(cfg, tx, mod.router),
                 ref_moe.aux_load_loss(ref_cfg, jx, jnp.asarray(prm["router"])), **TOL)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def ssd_inputs(b=2, l=32, h=3, p=8, n=4):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(b, l, h))) * 0.5).astype(np.float32),
            (rng.normal(size=(h,)) * 0.3).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32, 12])
def test_ssd_chunked(chunk):
    """Against the reference and against the naive O(L·N) recurrence (chunk
    12 halves to 8, as the reference's)."""
    x, dt, a_log, bm, cm = ssd_inputs()
    state0 = np.random.default_rng(5).normal(size=(2, 3, 8, 4)).astype(np.float32)
    for s_in in (None, state0):
        y, s = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bm, cm)), chunk,
                                  None if s_in is None else torch.from_numpy(s_in))
        ry, rs = ref_mamba2.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), chunk,
                                        None if s_in is None else jnp.asarray(s_in))
        assert_close(y, ry, **TOL)
        assert_close(s, rs, **TOL)
    want = np.zeros_like(x)
    state = np.zeros((2, 3, 8, 4), np.float32)
    A = -np.exp(a_log)
    for t in range(x.shape[1]):
        decay = np.exp(A[None] * dt[:, t])
        state = state * decay[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        want[:, t] = np.einsum("bn,bhpn->bhp", cm[:, t], state)
    y, s = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bm, cm)), chunk)
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), state, rtol=2e-4, atol=2e-4)


def test_ssd_gradient_finite_at_a_long_chunk():
    """A 256-token chunk whose decay sums overflow above the diagonal
    (exp(li) of a positive li past float32's range): the values equal the
    reference's, and the gradient is finite, equal to the 8-token chunks'
    (the reference's own gradient is NaN here: its where(causal, exp(li),
    0) routes 0 * inf into the backward)."""
    x, dt, a_log, bm, cm = ssd_inputs(l=256)
    dt = dt * 4.0  # decay sums of ~-300 over the chunk: exp(300) overflows
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, a_log, bm, cm)]
    y, s = mamba2.ssd_chunked(*ins, 256)
    ry, rs = ref_mamba2.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), 256)
    # 256-term float32 sums of terms up to ~10, in the reference's einsum
    # order against the port's two products
    assert_close(y, ry, atol=2e-3, rtol=2e-3)
    assert_close(s, rs, atol=1e-4, rtol=1e-4)
    g = torch.autograd.grad((y * y).sum() + (s * s).sum(), ins)
    short = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, a_log, bm, cm)]
    y8, s8 = mamba2.ssd_chunked(*short, 8)
    g8 = torch.autograd.grad((y8 * y8).sum() + (s8 * s8).sum(), short)
    # within 1e-4 of each input's largest: the two chunkings' float32 sums
    # run in other orders (2.6e-5 at most here)
    for a, b in zip(g, g8):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def ssm_setup(arch="mamba2-130m"):
    ref_cfg, cfg = reduced(arch)
    prm = rand_tree(mamba2.ssm_defs(cfg), 14)
    prm["dt_bias"] = prm["dt_bias"] - 1.0  # step sizes of a trained model's order
    return ref_cfg, cfg, prm, api.load_reference(mamba2.SSM(cfg, "cpu"), prm)


@pytest.mark.parametrize("l", [3, 16, 20])
def test_ssm_block_and_cache(l):
    """The mixer's output and its decode cache (final state, raw conv tails);
    20 is not a multiple of the chunk (8), so the SSD chunk halves to 4."""
    ref_cfg, cfg, prm, mod = ssm_setup()
    x, jx, tx = x_of((2, l, cfg.d_model), 15)
    y, cache = mamba2.ssm_block(cfg, mod, tx, want_cache=True)
    ry, rcache = ref_mamba2.ssm_block(ref_cfg, jtree(prm), jx, want_cache=True)
    assert_close(y, ry, **TOL)
    assert set(cache) == set(rcache)
    for k in cache:
        assert_close(cache[k], rcache[k], **TOL, what=k)
    y2, s_last = mamba2.ssm_block(cfg, mod, tx)
    assert_close(s_last, rcache["state"], **TOL)


def test_ssm_decode_step():
    ref_cfg, cfg, prm, mod = ssm_setup()
    _, jx, tx = x_of((2, 12, cfg.d_model), 16)
    _, cache = mamba2.ssm_block(cfg, mod, tx, want_cache=True)
    _, rcache = ref_mamba2.ssm_block(ref_cfg, jtree(prm), jx, want_cache=True)
    _, jt, tt = x_of((2, 1, cfg.d_model), 17)
    for step in range(3):
        y, cache = mamba2.ssm_decode_step(cfg, mod, tt, cache)
        ry, rcache = ref_mamba2.ssm_decode_step(ref_cfg, jtree(prm), jt, rcache)
        assert_close(y, ry, **TOL, what=f"step {step}")
        for k in cache:
            assert_close(cache[k], rcache[k], **TOL, what=k)
    # the cache defs describe what the block returns
    for k, pd in mamba2.ssm_cache_defs(cfg, 2).items():
        assert tuple(cache[k].shape) == pd.shape
        assert cache[k].dtype == sharding.resolve_dtype(pd, cfg.param_dtype)


def test_causal_conv_and_softplus():
    x, jx, tx = x_of((2, 9, 6), 18)
    w = np.random.default_rng(19).normal(size=(4, 6)).astype(np.float32)
    assert_close(mamba2._causal_conv(tx, torch.from_numpy(w)),
                 ref_mamba2._causal_conv(jx, jnp.asarray(w)), **TOL)
    v = np.array([-50.0, -3.0, 0.0, 0.5, 19.0, 25.0, 80.0], np.float32)
    assert_close(mamba2.softplus(torch.from_numpy(v)), jax.nn.softplus(jnp.asarray(v)),
                 atol=0, rtol=1e-6)
