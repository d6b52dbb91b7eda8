"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

The port of ``repro.models.mamba2``. Chunked SSD: the sequence is cut into
chunks of ``Q`` (halved until it divides the length); within a chunk the
quadratic "attention-like" term, between chunks a loop carries the
(H, P, N) state and hands each chunk the state *entering* it. Decode is
the O(1) recurrent update. ``softplus`` runs in float32 on
``dt + dt_bias``; the decode cache keeps the conv tails of the RAW
pre-conv projections.
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
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, ssm_defs(cfg), device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (W, C) -> (B, L, C)."""
    wlen = w.shape[0]
    xp = F.pad(x, (0, 0, wlen - 1, 0))
    out = torch.zeros_like(x)
    for i in range(wlen):  # W is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
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
    a_log: torch.Tensor,  # (H,) log of -A
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
    decay = torch.where(causal, torch.exp(li), torch.zeros((), dtype=f32, device=x.device))
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


def ssm_block(
    cfg: ModelConfig, prm: SSM, x: torch.Tensor, state_in=None, want_cache=False
) -> Tuple[torch.Tensor, Any]:
    """Full-sequence Mamba-2 mixer: x (B, L, d) -> (B, L, d), cache.

    ``want_cache=True`` returns the full decode cache (final SSD state +
    conv tail buffers of the RAW pre-conv projections)."""
    b, l, _ = x.shape
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    z = torch.matmul(x, prm.wz)
    xr = torch.matmul(x, prm.wx)
    br = torch.matmul(x, prm.wB)
    cr = torch.matmul(x, prm.wC)
    dt = torch.matmul(x, prm.wdt)
    xi = F.silu(_causal_conv(xr, prm.conv_x))
    bm = F.silu(_causal_conv(br, prm.conv_B))
    cm = F.silu(_causal_conv(cr, prm.conv_C))
    dt = softplus(dt.float() + prm.dt_bias)
    y, s_last = ssd_chunked(
        xi.reshape(b, l, h, p), dt, prm.A_log, bm, cm, cfg.ssm_chunk, state_in
    )
    y = y + (prm.D.float()[:, None] * xi.reshape(b, l, h, p)).to(y.dtype)
    y = layers.rmsnorm(y.reshape(b, l, -1), prm.gate_norm) * F.silu(z)
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


def ssm_decode_step(
    cfg: ModelConfig, prm: SSM, x: torch.Tensor, cache: Dict
) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) one token -> (B, 1, d), updated cache (new tensors)."""
    b = x.shape[0]
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
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
    dt = softplus(dt.float() + prm.dt_bias)  # (B, H)
    a = torch.exp(-torch.exp(prm.A_log) * dt)  # (B, H)
    xh = xi.reshape(b, h, p).float()
    s = cache["state"] * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bm.float()
    )
    y = torch.einsum("bn,bhpn->bhp", cm.float(), s)
    y = y + prm.D[:, None] * xh
    y = y.reshape(b, -1).to(x.dtype)
    y = layers.rmsnorm(y, prm.gate_norm) * F.silu(z)
    out = (y @ prm.wo)[:, None]
    return out, dict(state=s, conv_x=cx, conv_B=cb, conv_C=cc)
