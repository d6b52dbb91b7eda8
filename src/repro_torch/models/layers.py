"""Transformer building blocks: norms, RoPE, GQA attention, gated MLP.

The port of ``repro.models.layers``. Attention is memory-bounded as in the
reference:

* train/prefill: a loop over query chunks (``attn_chunking``);
  sliding-window layers slice only ``window + chunk`` keys per query chunk,
  so local layers are sub-quadratic in work, not just masked.
* decode: one-token query against a static cache with a ``pos`` validity
  mask; the new K/V is written into the cache in place.

GQA is expressed by reshaping query heads into ``(kv_heads, group)``.
Scores are produced in the input dtype, then cast to float32 and scaled;
the softmax runs in float32 and is cast back to ``v``'s dtype, the
reference's order (it is what a bfloat16 run computes).

The functions take a module (``p``) whose parameters are the reference's
leaves under the same names: :class:`Norm`, :class:`Attention`,
:class:`MLP`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PD, resolve_dtype

NEG_INF = -1e30


def tp_param(cfg: ModelConfig, pd: PD, device, tp=None, fsdp=None) -> nn.Parameter:
    """An uninitialised parameter of ``pd`` in the config's parameter dtype:
    its global shape, or under tensor parallelism (``tp``, a
    :class:`~repro_torch.core.collectives.TensorParallel`) the held blocks
    ``[n_local, *block]`` of a leaf split over the model axis, its split
    dimension in ``tp_dim`` (None: replicated); under FSDP (``fsdp``, a
    :class:`~repro_torch.core.collectives.FullyShardedData`) a leaf split
    over the data axes holds the data ranks' blocks of that in front, its
    split dimension in ``fsdp_dim`` (None: held whole)."""
    shape = pd.shape if tp is None else tp.param_shape(pd)
    if fsdp is not None:
        shape = fsdp.param_shape(pd, tp)
    prm = nn.Parameter(torch.empty(shape, dtype=resolve_dtype(pd, cfg.param_dtype),
                                   device=device), requires_grad=False)
    prm.tp_dim = None if tp is None else tp.split_dim(pd)
    prm.fsdp_dim = None if fsdp is None else fsdp.split_dim(pd)
    return prm


class ParamModule(nn.Module):
    """A module whose parameters are the PD leaves of ``defs``, allocated
    (uninitialised) on ``device`` in the config's parameter dtype; the
    weights come from ``api.init_params`` or ``api.from_reference``. With
    ``tp`` (``fsdp``) a leaf split over the model (data) axis holds its
    blocks (:func:`tp_param`)."""

    def __init__(self, cfg: ModelConfig, defs: Dict[str, PD], device, tp=None, fsdp=None):
        super().__init__()
        self.cfg = cfg
        for name, pd in defs.items():
            self.register_parameter(name, tp_param(cfg, pd, device, tp, fsdp))

    def split(self, name: str) -> bool:
        """Whether parameter ``name`` is split over the model axis."""
        return getattr(self, name).tp_dim is not None


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.float())
    return x.to(dt)


def layernorm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Parametric LN, or OLMo's non-parametric LN when scale/bias are None."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def norm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    """Pre-block norm params (empty dict for non-parametric LN)."""
    if cfg.norm == "layernorm_np":
        return {}
    if cfg.norm == "layernorm":
        return {
            "scale": PD((cfg.d_model,), ("embed",), "ones"),
            "bias": PD((cfg.d_model,), ("embed",), "zeros"),
        }
    return {"scale": PD((cfg.d_model,), ("embed",), "zeros")}  # rmsnorm (+1)


class Norm(ParamModule):
    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__(cfg, norm_defs(cfg), device, tp)

    def forward(self, x):
        return apply_norm(self.cfg, self, x)


def apply_norm(cfg: ModelConfig, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm_np":
        return layernorm(x)
    if cfg.norm == "layernorm":
        return layernorm(x, p.scale, p.bias)
    return rmsnorm(x, p.scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, H, D); positions: broadcastable to (..., L)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq  # (..., L, half)
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": PD((d, hq, hd), ("embed", "heads", None), "scaled"),
        "wk": PD((d, hk, hd), ("embed", "kv_heads", None), "scaled"),
        "wv": PD((d, hk, hd), ("embed", "kv_heads", None), "scaled"),
        "wo": PD((hq, hd, d), ("heads", None, "embed"), "scaled"),
    }
    if cfg.qk_norm:
        p["qnorm"] = PD((hd,), (None,), "zeros")
        p["knorm"] = PD((hd,), (None,), "zeros")
    return p


class Attention(ParamModule):
    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__(cfg, attn_defs(cfg), device, tp)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, h, k) -> (..., h, k)."""
    return torch.einsum("...d,dhk->...hk", x, w)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, L, H, D) @ wo (H, D, d) -> (B, L, d)."""
    return torch.einsum("blhd,hdk->blk", o, wo)


def _qk_project(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, positions: torch.Tensor):
    """x (..., L, d) -> q (..., L, Hq, D), k/v (..., L, Hk, D) with RoPE."""
    q = _proj(x, p.wq)
    k = _proj(x, p.wk)
    v = _proj(x, p.wv)
    if cfg.qk_norm:
        q = rmsnorm(q, p.qnorm)
        k = rmsnorm(k, p.knorm)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(valid: torch.Tensor) -> torch.Tensor:
    """A boolean validity array -> its additive float32 mask."""
    return torch.zeros(valid.shape, dtype=torch.float32,
                       device=valid.device).masked_fill_(~valid, NEG_INF)


def _sdpa(
    q: torch.Tensor,  # (B, Lq, Hk, G, D)
    k: torch.Tensor,  # (B, Lk, Hk, D)
    v: torch.Tensor,  # (B, Lk, Hk, D)
    mask: Optional[torch.Tensor],  # broadcastable to (B, Hk, G, Lq, Lk), additive
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def attn_chunking(cfg: ModelConfig, l: int, causal: bool = True):
    """Query-chunking plan: (q_chunk, n_chunks, unroll), the reference's.

    Short or non-causal sequences run in ONE chunk; above 2048 tokens the
    chunk halves from 1024 until it divides the length."""
    if not causal or l <= 2048:
        return l, 1, 1
    q_chunk = min(1024, l)
    while l % q_chunk:
        q_chunk //= 2
    n = l // q_chunk
    unroll = n if (cfg.scan_unroll and n <= 8) else 1
    return q_chunk, n, unroll


def self_attention(
    cfg: ModelConfig,
    p: nn.Module,
    x: torch.Tensor,  # (B, L, d)
    *,
    window: Optional[int] = None,  # sliding window; None = global
    causal: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (train / prefill).

    Returns (out (B, L, d), (k, v)) so prefill can keep the cache. Loops
    over query chunks; when ``window`` is set, only a ``window + chunk`` key
    slice is touched per chunk."""
    b, l, d = x.shape
    hk, hq, hd = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    g = hq // hk
    positions = torch.arange(l, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _qk_project(cfg, p, x, positions)
    out = _attend(cfg, q.reshape(b, l, hk, g, hd), k, v, window, causal)
    y = _out(out.reshape(b, l, hq, hd), p.wo)
    return y, (k, v)


def _attend(cfg: ModelConfig, qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: Optional[int], causal: bool) -> torch.Tensor:
    """The chunked attention of :func:`self_attention`: qg (B, L, Hk, G, D)
    against k/v (B, L, Hk, D) -> (B, L, Hk, G, D)."""
    b, l, hk, _, hd = qg.shape
    dev = qg.device
    q_chunk, n_chunks, _ = attn_chunking(cfg, l, causal)

    use_window = window is not None and causal and window < l
    if use_window:
        # key-slice length window + chunk; left-pad by WINDOW so padded
        # index q0 + j holds key (q0 - window + j).
        klen = window + q_chunk
        pad = torch.zeros((b, window, hk, hd), dtype=k.dtype, device=dev)
        kp = torch.cat([pad, k], dim=1)
        vp = torch.cat([pad, v], dim=1)

    outs = []
    for ci in range(n_chunks):
        q0 = ci * q_chunk
        qc = qg[:, q0:q0 + q_chunk]
        qpos = q0 + torch.arange(q_chunk, dtype=torch.int32, device=dev)
        if use_window:
            # keys for [q0 - window, q0 + q_chunk): slice from padded arrays
            kc, vc = kp[:, q0:q0 + klen], vp[:, q0:q0 + klen]
            kpos = q0 - window + torch.arange(klen, dtype=torch.int32, device=dev)
            valid = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            valid &= (qpos[:, None] - kpos[None, :]) < window
            outs.append(_sdpa(qc, kc, vc, _mask(valid)))
        else:
            kpos = torch.arange(l, dtype=torch.int32, device=dev)
            if causal:
                valid = kpos[None, :] <= qpos[:, None]
            else:
                valid = torch.ones((q_chunk, l), dtype=torch.bool, device=dev)
            if window is not None and causal:
                valid &= (qpos[:, None] - kpos[None, :]) < window
            outs.append(_sdpa(qc, k, v, _mask(valid)))
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)


def cross_attention(
    cfg: ModelConfig,
    p: nn.Module,
    x: torch.Tensor,  # (B, Lq, d) decoder states
    kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (k, v): (B, Lk, Hk, D)
) -> torch.Tensor:
    b, lq, _ = x.shape
    hk, hq, hd = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    g = hq // hk
    q = _proj(x, p.wq)
    if cfg.qk_norm:
        q = rmsnorm(q, p.qnorm)
    k, v = kv
    out = _sdpa(q.reshape(b, lq, hk, g, hd), k, v, None)
    return _out(out.reshape(b, lq, hq, hd), p.wo)


def cross_kv(cfg: ModelConfig, p: nn.Module, enc: torch.Tensor):
    """Precompute encoder-side K/V for cross attention."""
    k = _proj(enc, p.wk)
    v = _proj(enc, p.wv)
    if cfg.qk_norm:
        k = rmsnorm(k, p.knorm)
    return k, v


def _decode_q(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, pos: int):
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    return _qk_project(cfg, p, x, positions)


def decode_attention(
    cfg: ModelConfig,
    p: nn.Module,
    x: torch.Tensor,  # (B, 1, d) current-token states
    cache_k: torch.Tensor,  # (B, S, Hk, D)
    cache_v: torch.Tensor,
    pos: int,  # tokens already in cache
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a static cache. Writes the new k/v at
    ``pos`` in place and returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    s = cache_k.shape[1]
    hk, hq, hd = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _decode_q(cfg, p, x, pos)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    idx = torch.arange(s, dtype=torch.int32, device=x.device)
    valid = idx <= pos
    if window is not None:
        valid &= (pos - idx) < window
    out = _sdpa(q.reshape(b, 1, hk, hq // hk, hd), cache_k, cache_v, _mask(valid))
    return _out(out.reshape(b, 1, hq, hd), p.wo), cache_k, cache_v


def decode_attention_ring(
    cfg: ModelConfig,
    p: nn.Module,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, W, Hk, D) ring buffer, W == window
    cache_v: torch.Tensor,
    pos: int,  # absolute position being written
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window decode against a RING cache: slot ``j`` holds absolute
    position ``pos - ((pos - j) mod W)``; the new token overwrites slot
    ``pos % W`` (RoPE is applied at write time, so stored keys carry their
    true positions)."""
    b = x.shape[0]
    w = cache_k.shape[1]
    hk, hq, hd = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _decode_q(cfg, p, x, pos)
    slot = pos % w
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    j = torch.arange(w, dtype=torch.int32, device=x.device)
    p_j = pos - torch.remainder(pos - j, w)  # absolute position held by slot j
    valid = p_j >= 0  # window bound (pos - p_j < w) holds by construction
    out = _sdpa(q.reshape(b, 1, hk, hq // hk, hd), cache_k, cache_v, _mask(valid))
    return _out(out.reshape(b, 1, hq, hd), p.wo), cache_k, cache_v


def to_ring(k: torch.Tensor, pos: int, window: int) -> torch.Tensor:
    """Convert a full prefill cache (..., S, H, D) with `pos` valid entries to
    the ring layout (..., W, H, D): slot j <- absolute position
    pos-1 - ((pos-1 - j) mod W) (the last W positions, ring-indexed)."""
    ax = k.ndim - 3
    j = torch.arange(window, device=k.device)
    src = (pos - 1) - torch.remainder((pos - 1) - j, window)
    src = torch.clamp(src, 0, k.shape[ax] - 1)
    return torch.index_select(k, ax, src)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU); whisper uses plain GELU MLP
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, PD]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.family == "audio":  # whisper: non-gated GELU MLP
        return {
            "wi": PD((d, f), ("embed", "ff"), "scaled"),
            "wo": PD((f, d), ("ff", "embed"), "scaled"),
        }
    return {
        "wi": PD((d, f), ("embed", "ff"), "scaled"),
        "wg": PD((d, f), ("embed", "ff"), "scaled"),
        "wo": PD((f, d), ("ff", "embed"), "scaled"),
    }


class MLP(ParamModule):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None, tp=None):
        super().__init__(cfg, mlp_defs(cfg, d_ff), device, tp)


def mlp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if not hasattr(p, "wg"):
        # jax.nn.gelu is the tanh approximation by default
        h = F.gelu(torch.matmul(x, p.wi), approximate="tanh")
        return torch.matmul(h, p.wo)
    h = F.silu(torch.matmul(x, p.wg))
    h = h * torch.matmul(x, p.wi)
    return torch.matmul(h, p.wo)


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------
#
# ``tp`` is a :class:`~repro_torch.core.collectives.TensorParallel`. A
# sharded tensor carries the held model ranks on a leading axis ``n``; a
# replicated one has none (see its docstring). Attention is column-parallel
# over heads in ``wq`` (and ``wk``/``wv`` when the kv heads divide the
# model axis) and row-parallel in ``wo``; the MLP column-parallel in
# ``wi``/``wg`` over ``ff`` and row-parallel in ``wo``. A replicated tensor
# enters sharded compute through ``tp.copy`` (its gradient all-reduced), so
# every replicated parameter's gradient is whole on every rank.


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (n, ..., k) @ w (n, k, m) -> (n, ..., m), one product a held rank."""
    return torch.matmul(x.flatten(1, -2), w).unflatten(1, x.shape[1:-1])


def _kv_of_heads(cfg: ModelConfig, tp, device) -> torch.Tensor:
    """int64[n, hq/M]: the kv head of each held rank's query heads (for kv
    heads replicated over the model axis)."""
    hl = cfg.n_heads // tp.size
    heads = tp.local_index(device)[:, None] * hl + torch.arange(hl, device=device)
    return heads // (cfg.n_heads // cfg.n_kv_heads)


def _qkv_tp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, positions: torch.Tensor, tp):
    """x (B, L, d) replicated -> q (n, B, L, hq/M, D), the keys and values
    each rank attends with (n, B, L, h', D) and their heads' group size,
    and a function giving the replicated (B, L, Hk, D) k/v of the cache."""
    xm = tp.copy(x)
    q = torch.einsum("nbld,ndhk->nblhk", xm, p.wq)
    if cfg.qk_norm:
        q = rmsnorm(q, tp.copy(p.qnorm, rows=False)[:, None, None, None])
    q = rope(q, positions, cfg.rope_theta)
    if p.split("wk"):
        k = torch.einsum("nbld,ndhk->nblhk", xm, p.wk)
        v = torch.einsum("nbld,ndhk->nblhk", xm, p.wv)
        if cfg.qk_norm:
            k = rmsnorm(k, tp.copy(p.knorm, rows=False)[:, None, None, None])
        k = rope(k, positions, cfg.rope_theta)
        g = q.shape[3] // k.shape[3]
        return q, k, v, g, lambda: (tp.gather(k, -2), tp.gather(v, -2))
    # kv heads do not divide the model axis: wk/wv replicated, every rank
    # computes all kv heads and keeps its own query heads' (group size 1)
    k = _proj(x, p.wk)
    v = _proj(x, p.wv)
    if cfg.qk_norm:
        k = rmsnorm(k, p.knorm)
    k = rope(k, positions, cfg.rope_theta)
    ks, vs = _select_kv_tp(cfg, k, v, tp)
    return q, ks, vs, 1, lambda: (k, v)


def _select_kv_tp(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, tp):
    """Replicated k/v (B, S, Hk, D) -> each held rank's query heads' kv
    heads (n, B, S, hq/M, D), through ``tp.copy`` (gradient all-reduced)."""
    idx = _kv_of_heads(cfg, tp, k.device)
    shape = (idx.shape[0],) + tuple(k.shape[:-2]) + (idx.shape[1], k.shape[-1])
    sel = idx.reshape((idx.shape[0],) + (1,) * (k.dim() - 2) + (idx.shape[1], 1)).expand(shape)
    return torch.gather(tp.copy(k), -2, sel), torch.gather(tp.copy(v), -2, sel)


def self_attention_tp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, tp, *,
                      window: Optional[int] = None, causal: bool = True,
                      want_kv: bool = False):
    """:func:`self_attention` with the heads over the model axis: -> (out
    (B, L, d) replicated, the replicated (k, v) of the cache when
    ``want_kv``, else None). Split kv heads are all-gathered for the
    cache only."""
    if not p.split("wq"):
        y, kv = self_attention(cfg, p, x, window=window, causal=causal)
        return y, (kv if want_kv else None)
    b, l, _ = x.shape
    positions = torch.arange(l, dtype=torch.int32, device=x.device)[None, :]
    q, k, v, g, cache_kv = _qkv_tp(cfg, p, x, positions, tp)
    n, hl, hd = q.shape[0], q.shape[3], q.shape[4]
    hk = k.shape[3]
    out = _attend(cfg, q.reshape(n * b, l, hk, g, hd), k.reshape(n * b, l, hk, hd),
                  v.reshape(n * b, l, hk, hd), window, causal)
    y = torch.einsum("nblhd,nhdk->nblk", out.reshape(n, b, l, hl, hd), p.wo)
    return tp.reduce(y), (cache_kv() if want_kv else None)


def _cache_heads(cfg: ModelConfig, p: nn.Module, cache: torch.Tensor, tp) -> torch.Tensor:
    """The replicated cache (B, S, Hk, D) -> each held rank's heads, folded
    into the batch: (n * B, S, h', D)."""
    b, s, hk, hd = cache.shape
    if p.split("wk"):
        blocks = cache.unflatten(2, (tp.size, hk // tp.size)).movedim(2, 0)
        if tp.n_local != tp.size:
            blocks = blocks[tp.local_index(cache.device)]
    else:
        idx = _kv_of_heads(cfg, tp, cache.device)
        blocks = cache.index_select(2, idx.flatten()).unflatten(2, idx.shape).movedim(2, 0)
    return blocks.reshape((-1, s) + tuple(blocks.shape[-2:]))


def decode_attention_tp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor,
                        cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int, tp, *,
                        window: Optional[int] = None, ring: bool = False) -> torch.Tensor:
    """:func:`decode_attention` (``ring``: :func:`decode_attention_ring`)
    with the heads over the model axis. The cache keeps the reference's
    replicated layout: split kv heads' new entries are all-gathered into
    it, then each rank attends with its own heads. Returns the replicated
    (B, 1, d) output; the cache is written in place."""
    if not p.split("wq"):
        if ring:
            return decode_attention_ring(cfg, p, x, cache_k, cache_v, pos)[0]
        return decode_attention(cfg, p, x, cache_k, cache_v, pos, window=window)[0]
    b = x.shape[0]
    s = cache_k.shape[1]
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, _, _, _, cache_kv = _qkv_tp(cfg, p, x, positions, tp)
    k, v = cache_kv()
    slot = pos % s if ring else pos
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    j = torch.arange(s, dtype=torch.int32, device=x.device)
    if ring:
        valid = pos - torch.remainder(pos - j, s) >= 0
    else:
        valid = j <= pos
        if window is not None:
            valid &= (pos - j) < window
    kc = _cache_heads(cfg, p, cache_k, tp)
    vc = _cache_heads(cfg, p, cache_v, tp)
    n, hl, hd = q.shape[0], q.shape[3], q.shape[4]
    hk = kc.shape[2]
    out = _sdpa(q.reshape(n * b, 1, hk, hl // hk, hd), kc, vc, _mask(valid))
    y = torch.einsum("nblhd,nhdk->nblk", out.reshape(n, b, 1, hl, hd), p.wo)
    return tp.reduce(y)


def cross_kv_tp(cfg: ModelConfig, p: nn.Module, enc: torch.Tensor, tp, want_kv: bool = False):
    """:func:`cross_kv` over the model axis: -> (the keys and values each
    held rank attends with, (n, B, F, h', D), the replicated (k, v) of the
    cross cache when ``want_kv``, else None). Split kv heads project from
    the encoder's output through ``tp.copy`` and are all-gathered for the
    cache only; kv heads that do not divide the axis are computed whole and
    each rank selects its query heads' (as :func:`_qkv_tp`). Unsplit query
    heads: the unsharded (k, v) twice."""
    if not p.split("wq"):
        kv = cross_kv(cfg, p, enc)
        return kv, (kv if want_kv else None)
    if not p.split("wk"):
        k, v = cross_kv(cfg, p, enc)
        return _select_kv_tp(cfg, k, v, tp), ((k, v) if want_kv else None)
    em = tp.copy(enc)
    k = torch.einsum("nbld,ndhk->nblhk", em, p.wk)
    v = torch.einsum("nbld,ndhk->nblhk", em, p.wv)
    if cfg.qk_norm:
        k = rmsnorm(k, tp.copy(p.knorm, rows=False)[:, None, None, None])
    return (k, v), ((tp.gather(k, -2), tp.gather(v, -2)) if want_kv else None)


def cross_heads_tp(cfg: ModelConfig, p: nn.Module, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, tp):
    """The replicated cross cache (B, F, Hk, D) -> :func:`cross_kv_tp`'s
    per-rank keys and values (no collective)."""
    if not p.split("wq"):
        return cache_k, cache_v
    n = tp.n_local
    return tuple(_cache_heads(cfg, p, c, tp).unflatten(0, (n, -1)) for c in (cache_k, cache_v))


def cross_attention_tp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, kv, tp) -> torch.Tensor:
    """:func:`cross_attention` with the heads over the model axis: ``kv``
    from :func:`cross_kv_tp` or :func:`cross_heads_tp`; the output
    row-parallel, all-reduced: the replicated (B, Lq, d)."""
    if not p.split("wq"):
        return cross_attention(cfg, p, x, kv)
    b, lq, _ = x.shape
    q = torch.einsum("nbld,ndhk->nblhk", tp.copy(x), p.wq)
    if cfg.qk_norm:
        q = rmsnorm(q, tp.copy(p.qnorm, rows=False)[:, None, None, None])
    k, v = kv
    n, hl, hd = q.shape[0], q.shape[3], q.shape[4]
    hk = k.shape[3]
    out = _sdpa(q.reshape(n * b, lq, hk, hl // hk, hd), k.flatten(0, 1), v.flatten(0, 1), None)
    y = torch.einsum("nblhd,nhdk->nblk", out.reshape(n, b, lq, hl, hd), p.wo)
    return tp.reduce(y)


def mlp_tp(cfg: ModelConfig, p: nn.Module, x: torch.Tensor, tp,
           partial: bool = False) -> torch.Tensor:
    """:func:`mlp` over the model axis: column-parallel ``wi``/``wg``,
    row-parallel ``wo``, the partial sums all-reduced (``partial``: the
    ``[n, ...]`` partial sums returned instead). Replicated when ``ff``
    does not divide the axis (then never partial)."""
    if not p.split("wi"):
        return mlp(cfg, p, x)
    xm = tp.copy(x)
    if not hasattr(p, "wg"):
        h = F.gelu(bmm(xm, p.wi), approximate="tanh")
    else:
        h = F.silu(bmm(xm, p.wg)) * bmm(xm, p.wi)
    y = bmm(h, p.wo)
    return y if partial else tp.reduce(y)
