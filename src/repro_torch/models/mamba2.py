"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

The port of ``repro.models.mamba2``. Chunked SSD: the sequence is cut into
chunks of ``Q`` (halved until it divides the length); within a chunk the
quadratic "attention-like" term, between chunks a loop carries the
(H, P, N) state and hands each chunk the state *entering* it. Decode is
the O(1) recurrent update. ``softplus`` runs in float32 on
``dt + dt_bias``; the decode cache keeps the conv tails of the RAW
pre-conv projections.

Over the model axis (``ssm_block_tp``, ``ssm_decode_step_tp``) the inner
width ``d_inner`` splits as the reference's spec splits it, leaf by leaf
with the divisibility fallback; see the section at the end.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PD
from repro_torch.models import layers


def ssm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    cw = cfg.ssm_conv_width
    return {
        "wz": PD((d, din), ("embed", "d_inner"), "scaled"),
        "wx": PD((d, din), ("embed", "d_inner"), "scaled"),
        "wB": PD((d, n), ("embed", None), "scaled"),
        "wC": PD((d, n), ("embed", None), "scaled"),
        "wdt": PD((d, h), ("embed", "d_inner"), "scaled"),
        "conv_x": PD((cw, din), (None, "d_inner"), "scaled"),
        "conv_B": PD((cw, n), (None, None), "scaled"),
        "conv_C": PD((cw, n), (None, None), "scaled"),
        "A_log": PD((h,), ("d_inner",), "zeros", dtype="float32"),
        "dt_bias": PD((h,), ("d_inner",), "zeros", dtype="float32"),
        "D": PD((h,), ("d_inner",), "ones", dtype="float32"),
        "gate_norm": PD((din,), ("d_inner",), "zeros"),
        "wo": PD((din, d), ("d_inner", "embed"), "scaled"),
    }


class SSM(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__(cfg, ssm_defs(cfg), device, tp)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (W, C) -> (B, L, C); or each
    held rank's, x (n, B, L, C) and w (n, W, C)."""
    wlen, l = w.shape[-2], x.shape[-2]
    xp = F.pad(x, (0, 0, wlen - 1, 0))
    out = torch.zeros_like(x)
    for i in range(wlen):  # W is tiny (4): unrolled taps
        out = out + xp[..., i:i + l, :] * w[..., i, None, None, :]
    return out


def ssd_chunk(chunk: int, l: int) -> int:
    """The SSD chunk for ``l`` tokens: ``chunk``, halved until it divides ``l``."""
    q = min(chunk, l)
    while l % q:
        q //= 2
    return q


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P) inputs
    dt: torch.Tensor,  # (B, L, H) softplus'd step sizes
    a_log: torch.Tensor,  # (H,), or (B, 1, H), log of -A
    bmat: torch.Tensor,  # (B, L, N)
    cmat: torch.Tensor,  # (B, L, N)
    chunk: int,
    state_in: torch.Tensor = None,  # (B, H, P, N) or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P), final state (B, H, P, N))."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    q = ssd_chunk(chunk, l)
    nc = l // q

    f32 = torch.float32
    xdt = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, q, h, p)
    a = (-torch.exp(a_log.to(f32)) * dt.to(f32)).reshape(b, nc, q, h)
    bc = bmat.to(f32).reshape(b, nc, q, n)
    cc = cmat.to(f32).reshape(b, nc, q, n)

    cum = torch.cumsum(a, dim=2)  # (b, nc, q, h) inclusive
    # --- intra-chunk (quadratic) term
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,h)
    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # masked before the exp: above the diagonal li is a growing positive sum
    # whose exp overflows, and where(causal, exp(li), 0)'s gradient is then
    # 0 * inf = NaN (the reference's is, at its 256-token chunk); the values
    # are the same
    decay = torch.exp(torch.where(causal, li, torch.full((), -torch.inf, dtype=f32,
                                                          device=x.device)))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)

    # --- inter-chunk state passing
    dend = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,q,h) decay to chunk end
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bc, dend[..., None] * xdt)
    gamma = torch.exp(cum[:, :, -1, :])  # (b,nc,h) whole-chunk decay

    s = (torch.zeros((b, h, p, n), dtype=f32, device=x.device) if state_in is None
         else state_in.to(f32))
    s_prev = []
    for c in range(nc):
        s_prev.append(s)  # the state *entering* chunk c
        s = s * gamma[:, c][..., None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)  # (b, nc, h, p, n)
    y = y + torch.einsum("bcin,bchpn->bcihp", cc, s_prev) * torch.exp(cum)[..., None]
    return y.reshape(b, l, h, p).to(x.dtype), s


def _heads(prm: SSM):
    """The per-head leaves :func:`_scan` and :func:`_recur` take."""
    return prm.dt_bias, prm.A_log, prm.D


def _scan(cfg: ModelConfig, heads, xi, dt, bm, cm, state_in=None):
    """The SSD scan and skip of the conv'd inputs ``xi`` (B, L, H * P) and
    raw step sizes ``dt`` (B, L, H) -> (y (B, L, H * P), final state).
    ``heads`` is (dt_bias, A_log, D), each (H,), or (B, 1, H) where held
    ranks are folded into the batch (:func:`_fold_heads`)."""
    b, l, h = dt.shape
    dt_bias, a_log, d_skip = heads
    xh = xi.reshape(b, l, h, cfg.ssm_head_dim)
    dt = softplus(dt.float() + dt_bias)
    y, s_last = ssd_chunked(xh, dt, a_log, bm, cm, cfg.ssm_chunk, state_in)
    y = y + (d_skip.float()[..., None] * xh).to(y.dtype)
    return y.reshape(b, l, -1), s_last


def ssm_block(
    cfg: ModelConfig, prm: SSM, x: torch.Tensor, state_in=None, want_cache=False
) -> Tuple[torch.Tensor, Any]:
    """Full-sequence Mamba-2 mixer: x (B, L, d) -> (B, L, d), cache.

    ``want_cache=True`` returns the full decode cache (final SSD state +
    conv tail buffers of the RAW pre-conv projections)."""
    b, l, _ = x.shape
    z = torch.matmul(x, prm.wz)
    xr = torch.matmul(x, prm.wx)
    br = torch.matmul(x, prm.wB)
    cr = torch.matmul(x, prm.wC)
    dt = torch.matmul(x, prm.wdt)
    xi = F.silu(_causal_conv(xr, prm.conv_x))
    bm = F.silu(_causal_conv(br, prm.conv_B))
    cm = F.silu(_causal_conv(cr, prm.conv_C))
    y, s_last = _scan(cfg, _heads(prm), xi, dt, bm, cm, state_in)
    y = layers.rmsnorm(y, prm.gate_norm) * F.silu(z)
    out = torch.matmul(y, prm.wo)
    if want_cache:
        cw = cfg.ssm_conv_width - 1
        cache = dict(
            state=s_last,
            conv_x=xr[:, l - cw:],
            conv_B=br[:, l - cw:],
            conv_C=cr[:, l - cw:],
        )
        return out, cache
    return out, s_last


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------


def ssm_cache_defs(cfg: ModelConfig, batch: int) -> Dict[str, PD]:
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cwm1 = cfg.ssm_conv_width - 1
    return {
        "state": PD((batch, h, p, n), ("batch", "d_inner", None, None), "zeros",
                    dtype="float32"),
        "conv_x": PD((batch, cwm1, cfg.d_inner), ("batch", None, "d_inner"), "zeros"),
        "conv_B": PD((batch, cwm1, n), ("batch", None, None), "zeros"),
        "conv_C": PD((batch, cwm1, n), ("batch", None, None), "zeros"),
    }


def _conv_step(buf: torch.Tensor, cur: torch.Tensor, w: torch.Tensor):
    """buf (B, W-1, C) history, cur (B, C) -> (out (B, C), new buf)."""
    full = torch.cat([buf, cur[:, None]], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", full, w)
    return out, full[:, 1:]


def _recur(cfg: ModelConfig, heads, state, xi, dt, bm, cm):
    """The recurrent step of the conv'd input ``xi`` (B, H * P) and raw
    step sizes ``dt`` (B, H) -> (y (B, H * P) float32, new state);
    ``heads`` as :func:`_scan`'s, each (H,) or (B, H)."""
    b, h = dt.shape
    dt_bias, a_log, d_skip = heads
    dt = softplus(dt.float() + dt_bias)  # (B, H)
    a = torch.exp(-torch.exp(a_log) * dt)  # (B, H)
    xh = xi.reshape(b, h, cfg.ssm_head_dim).float()
    s = state * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bm.float()
    )
    y = torch.einsum("bn,bhpn->bhp", cm.float(), s)
    y = y + d_skip[..., None] * xh
    return y.reshape(b, -1), s


def ssm_decode_step(
    cfg: ModelConfig, prm: SSM, x: torch.Tensor, cache: Dict
) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) one token -> (B, 1, d), updated cache (new tensors)."""
    xt = x[:, 0]
    z = xt @ prm.wz
    xi = xt @ prm.wx
    bm = xt @ prm.wB
    cm = xt @ prm.wC
    dt = xt @ prm.wdt
    xi, cx = _conv_step(cache["conv_x"], xi, prm.conv_x)
    bm, cb = _conv_step(cache["conv_B"], bm, prm.conv_B)
    cm, cc = _conv_step(cache["conv_C"], cm, prm.conv_C)
    xi, bm, cm = F.silu(xi), F.silu(bm), F.silu(cm)
    y, s = _recur(cfg, _heads(prm), cache["state"], xi, dt, bm, cm)
    y = layers.rmsnorm(y.to(x.dtype), prm.gate_norm) * F.silu(z)
    out = (y @ prm.wo)[:, None]
    return out, dict(state=s, conv_x=cx, conv_B=cb, conv_C=cc)


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------
#
# ``tp`` is a :class:`~repro_torch.core.collectives.TensorParallel` (layout
# in its docstring). ``wz``/``wx`` are column-parallel over ``d_inner``,
# ``conv_x`` depthwise (so local), ``gate_norm`` local, ``wo`` row-parallel
# (its partial sums all-reduced); ``wB``/``wC``/``conv_B``/``conv_C`` run
# once on the replicated input. When the SSM heads divide the model axis
# (``wdt``, ``A_log``, ``dt_bias``, ``D`` split) each rank scans its own
# heads; B and C enter that compute through one ``tp.copy`` (their gradient
# all-reduced). When they do not (the spec leaves those four leaves whole
# while ``d_inner`` splits, so a rank's columns hold part of a head) the
# conv'd inputs are all-gathered, the scan runs replicated, and each rank
# keeps its own columns of its output. The gate norm's mean spans the
# whole ``d_inner``: each rank's float32 sum of squares is all-reduced
# (``tp.reduce``) and enters its compute through ``tp.copy``, so its
# gradient is summed over the model ranks too.
#
# The decode cache holds its split leaves as blocks, ``[n_local, *block]``
# in the layer's place (the reference's spec splits ``state``'s head axis
# and ``conv_x``'s channels): a decode step needs no gather.
# ``api.global_cache`` / ``api.held_cache`` convert to the reference's
# layout and back.


def cache_split_dims(cfg: ModelConfig, tp) -> Dict[str, Any]:
    """The split dimension of each leaf of one layer's decode cache
    (:func:`ssm_cache_defs`) over ``tp``'s axes, or None: replicated."""
    return {k: tp.split_dim(pd) for k, pd in ssm_cache_defs(cfg, 1).items()}


def _gate_norm_tp(y: torch.Tensor, scale: torch.Tensor, width: int, tp,
                  eps: float = 1e-6) -> torch.Tensor:
    """:func:`layers.rmsnorm` over ``width`` columns split over the model
    axis: y (n, ..., width / M), scale (n, width / M); the float32 sum of
    squares all-reduced."""
    dt = y.dtype
    yf = y.float()
    ss = tp.copy(tp.reduce(torch.sum(yf * yf, dim=-1, keepdim=True)))
    yf = yf * torch.rsqrt(ss / width + eps)
    lead = (scale.shape[0],) + (1,) * (y.dim() - 2) + (scale.shape[-1],)
    return (yf * (1.0 + scale.float().reshape(lead))).to(dt)


def _fold_heads(prm: SSM, b: int, *mid: int):
    """The held ranks' per-head leaves (n, H / M) folded into a batch of
    ``b`` rows a rank: (n * b, *mid, H / M), as :func:`_scan` (``mid`` (1,))
    and :func:`_recur` (none) take them."""
    return tuple(t[:, None].expand(-1, b, -1).reshape(-1, *mid, t.shape[-1])
                 for t in _heads(prm))


def ssm_block_tp(cfg: ModelConfig, prm: SSM, x: torch.Tensor, tp, want_cache=False):
    """:func:`ssm_block` over the model axis: x (B, L, d) replicated -> (the
    replicated (B, L, d), the decode cache (split leaves as held blocks)
    when ``want_cache``, else None)."""
    if not prm.split("wx"):  # d_inner does not divide: the mixer is replicated
        out, cache = ssm_block(cfg, prm, x, want_cache=want_cache)
        return out, (cache if want_cache else None)
    b, l, _ = x.shape
    xm = tp.copy(x)
    z = layers.bmm(xm, prm.wz)  # (n, B, L, din/M)
    xr = layers.bmm(xm, prm.wx)
    br = torch.matmul(x, prm.wB)
    cr = torch.matmul(x, prm.wC)
    xi = F.silu(_causal_conv(xr, prm.conv_x))
    bm = F.silu(_causal_conv(br, prm.conv_B))
    cm = F.silu(_causal_conv(cr, prm.conv_C))
    n = xi.shape[0]
    if prm.split("A_log"):  # each rank scans its own heads, the ranks folded into the batch
        bc = tp.copy(torch.cat([bm, cm], dim=-1)).flatten(0, 1)
        nb = bm.shape[-1]
        y, s_last = _scan(cfg, _fold_heads(prm, b, 1), xi.flatten(0, 1),
                          layers.bmm(xm, prm.wdt).flatten(0, 1), bc[..., :nb], bc[..., nb:])
        y, s_last = y.unflatten(0, (n, b)), s_last.unflatten(0, (n, b))
    else:  # heads straddle the ranks: the scan runs replicated
        y, s_last = _scan(cfg, _heads(prm), tp.gather(xi, -1), torch.matmul(x, prm.wdt), bm, cm)
        y = tp.split(y, -1)
    y = _gate_norm_tp(y, prm.gate_norm, cfg.d_inner, tp) * F.silu(z)
    out = tp.reduce(layers.bmm(y, prm.wo))
    if not want_cache:
        return out, None
    cw = cfg.ssm_conv_width - 1
    return out, dict(state=s_last, conv_x=xr[:, :, l - cw:], conv_B=br[:, l - cw:],
                     conv_C=cr[:, l - cw:])


def ssm_decode_step_tp(cfg: ModelConfig, prm: SSM, x: torch.Tensor, cache: Dict, tp):
    """:func:`ssm_decode_step` over the model axis: x (B, 1, d) replicated,
    ``cache`` one layer's (split leaves as held blocks) -> (the replicated
    (B, 1, d), the updated cache (new tensors))."""
    if not prm.split("wx"):
        return ssm_decode_step(cfg, prm, x, cache)
    b = x.shape[0]
    xt = x[:, 0]
    xm = tp.copy(xt)
    z = layers.bmm(xm, prm.wz)  # (n, B, din/M)
    xi = layers.bmm(xm, prm.wx)
    bm = xt @ prm.wB
    cm = xt @ prm.wC
    full = torch.cat([cache["conv_x"], xi[:, :, None]], dim=2)  # (n, B, W, din/M)
    xi, cx = torch.einsum("nbwc,nwc->nbc", full, prm.conv_x), full[:, :, 1:]
    bm, cb = _conv_step(cache["conv_B"], bm, prm.conv_B)
    cm, cc = _conv_step(cache["conv_C"], cm, prm.conv_C)
    xi, bm, cm = F.silu(xi), F.silu(bm), F.silu(cm)
    n = xi.shape[0]
    if prm.split("A_log"):
        rows = [t.expand(n, -1, -1).flatten(0, 1) for t in (bm, cm)]
        y, s = _recur(cfg, _fold_heads(prm, b), cache["state"].flatten(0, 1), xi.flatten(0, 1),
                      layers.bmm(xm, prm.wdt).flatten(0, 1), *rows)
        y, s = y.unflatten(0, (n, b)), s.unflatten(0, (n, b))
    else:
        y, s = _recur(cfg, _heads(prm), cache["state"], tp.gather(xi, -1), xt @ prm.wdt, bm, cm)
        y = tp.split(y, -1)
    y = y.to(x.dtype)
    y = _gate_norm_tp(y, prm.gate_norm, cfg.d_inner, tp) * F.silu(z)
    out = tp.reduce(layers.bmm(y, prm.wo))[:, None]
    return out, dict(state=s, conv_x=cx, conv_B=cb, conv_C=cc)
