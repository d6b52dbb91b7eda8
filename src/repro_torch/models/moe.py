"""Mixture-of-Experts block: token-choice top-k, sort-based dispatch.

The port of ``repro.models.moe``. Routing is computed **per sequence row**
(never across rows), by a stable sort of the row's assignments by expert.
Each expert accepts at most ``C = ceil(L*k/E * capacity_factor)`` tokens per
row (multiple of 8); overflow assignments are dropped for that expert and
their combine weight is lost.

Ties: ``jax.lax.top_k`` puts the lower index first, which ``torch.topk``
does not promise, so the top-k is a stable descending sort. The combine
sums each token's contributions in the reference's scatter order (sorted
assignment order) without an atomic scatter, so it is the same on the card.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import PD
from repro_torch.models import layers


def _round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def capacity(cfg: ModelConfig, l: int) -> int:
    c = int(l * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return min(_round8(c), l)


def moe_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    p = {
        "router": PD((d, e), (None, "experts"), "normal", dtype="float32"),
        "wi": PD((e, d, f), ("experts", "embed", None), "scaled"),
        "wg": PD((e, d, f), ("experts", "embed", None), "scaled"),
        "wo": PD((e, f, d), ("experts", None, "embed"), "scaled"),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_expert * cfg.n_shared_experts
        p["shared"] = layers.mlp_defs(cfg, d_ff=fs)
    return p


class MoE(layers.ParamModule):
    def __init__(self, cfg: ModelConfig, device, tp=None):
        defs = moe_defs(cfg)
        shared = defs.pop("shared", None)
        super().__init__(cfg, defs, device, tp)
        if shared is not None:
            self.shared = layers.MLP(cfg, device,
                                     d_ff=cfg.d_expert * cfg.n_shared_experts, tp=tp)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_row(flat_e: torch.Tensor, k: int, cap: int):
    """Dispatch plan of each row. flat_e: (..., L*k) expert id of every
    (token, k) assignment. Returns (tok, slot, valid, order): for each sorted
    assignment, the source token, its slot in the (E*C) expert buffer, a
    keep mask, and the assignment it came from."""
    lk = flat_e.shape[-1]
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)  # by expert
    # position within the expert's group = index - first index of that expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(lk, device=flat_e.device) - first
    valid = pos < cap
    slot = torch.where(valid, sorted_e * cap + pos, torch.zeros_like(pos))
    tok = order // k
    return tok, slot, valid, order


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d), every row routed on its own."""
    logits = torch.einsum("bld,de->ble", x.float(), p.router)
    out = _routed(cfg, p, x, logits)
    if hasattr(p, "shared"):
        out = out + layers.mlp(cfg, p.shared, x)
    return out


def _dispatch(cfg: ModelConfig, x: torch.Tensor, logits: torch.Tensor):
    """The router's top-k and each row's dispatch: -> (buf (B, E, C, d),
    the plan (tok, slot, valid, order) and the combine weights (B, L*k))."""
    b, l, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, l)
    probs = torch.softmax(logits, dim=-1)
    w, sel = top_k(probs, k)  # (B, L, k)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)

    tok, slot, valid, order = _route_row(sel.reshape(b, l * k), k, cap)

    # dispatch: valid slots are unique per row; dropped assignments add a
    # zero row to slot 0, as the reference's scatter-add does
    gathered = torch.gather(x, 1, tok[..., None].expand(-1, -1, d))
    gathered = gathered * valid[..., None].to(x.dtype)
    buf = torch.zeros((b, e * cap, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(-1, -1, d), gathered)
    return buf.reshape(b, e, cap, d), (tok, slot, valid, order), w.reshape(b, l * k)


def _by_token(contrib: torch.Tensor, order: torch.Tensor, l: int, k: int) -> torch.Tensor:
    """(..., B, L*k, d) contributions in sorted-assignment order -> each
    token's k contributions summed in that order: (..., B, L, d)."""
    d = contrib.shape[-1]
    rank = torch.argsort(order, dim=-1)  # assignment -> its sorted position
    by_tok = torch.sort(rank.reshape(rank.shape[:-1] + (l, k)), dim=-1).values
    by_tok = by_tok.reshape(rank.shape).expand(contrib.shape[:-1])
    parts = torch.gather(contrib, -2, by_tok[..., None].expand(contrib.shape))
    parts = parts.reshape(contrib.shape[:-2] + (l, k, d))
    out = torch.zeros(contrib.shape[:-2] + (l, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + parts[..., j, :]
    return out


def _routed(cfg: ModelConfig, p: MoE, x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The routed experts' output (B, L, d) of router ``logits``."""
    b, l, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, l)
    buf, (tok, slot, valid, order), w_flat = _dispatch(cfg, x, logits)

    h = F.silu(torch.einsum("becd,edf->becf", buf, p.wg))
    h = h * torch.einsum("becd,edf->becf", buf, p.wi)
    y = torch.einsum("becf,efd->becd", h, p.wo).reshape(b, e * cap, d)

    scale = (torch.gather(w_flat, 1, order) * valid)[..., None].to(y.dtype)
    contrib = torch.gather(y, 1, slot[..., None].expand(-1, -1, d)) * scale
    return _by_token(contrib, order, l, k)


def moe_block_tp(cfg: ModelConfig, p: MoE, x: torch.Tensor, tp) -> torch.Tensor:
    """:func:`moe_block` with the experts over the model axis (``tp``, a
    :class:`~repro_torch.core.collectives.TensorParallel`). The router's
    logits, split over experts, are all-gathered before the top-k; each
    row's dispatch plan is computed whole on every rank; each rank runs its
    own experts on its block of the dispatch buffer and combines their
    contributions; the partial outputs (with a split shared expert's) are
    summed by one all-reduce. Experts that do not divide the axis run
    replicated."""
    b, l, d = x.shape
    k = cfg.experts_per_token
    cap = capacity(cfg, l)
    if p.split("router"):
        logits = tp.gather(torch.einsum("nbld,nde->nble", tp.copy(x.float()), p.router), -1)
    else:
        logits = torch.einsum("bld,de->ble", x.float(), p.router)
    shared = hasattr(p, "shared")
    if not p.split("wi"):
        out = _routed(cfg, p, x, logits)
        return out + layers.mlp_tp(cfg, p.shared, x, tp) if shared else out
    buf, (_, slot, valid, order), w_flat = _dispatch(cfg, x, logits)
    mine = tp.split(buf, 1)  # (n, B, E/M, C, d)
    h = F.silu(torch.einsum("nbecd,nedf->nbecf", mine, p.wg))
    h = h * torch.einsum("nbecd,nedf->nbecf", mine, p.wi)
    y = torch.einsum("nbecf,nefd->nbecd", h, p.wo)
    n, width = y.shape[0], y.shape[2] * cap
    y = y.reshape(n, b, width, d)
    # each rank's own slots of the (E*C) buffer
    lo = tp.local_index(x.device) * width
    local = slot[None] - lo[:, None, None]  # (n, B, L*k)
    own = (local >= 0) & (local < width) & valid[None]
    scale = (tp.copy(torch.gather(w_flat, 1, order)) * own)[..., None].to(y.dtype)
    idx = local.clamp(0, width - 1)[..., None].expand(-1, -1, -1, d)
    out = _by_token(torch.gather(y, 2, idx) * scale, order[None].expand(n, -1, -1), l, k)
    if shared and p.shared.split("wi"):
        return tp.reduce(out + layers.mlp_tp(cfg, p.shared, x, tp, partial=True))
    out = tp.reduce(out)
    return out + layers.mlp(cfg, p.shared, x) if shared else out


def aux_load_loss(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over rows)."""
    logits = torch.einsum("bld,de->ble", x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    _, sel = top_k(probs, cfg.experts_per_token)
    e = cfg.n_experts
    hot = F.one_hot(sel, e).sum(dim=2).float()  # (B, L, E)
    frac_tokens = hot.mean(dim=1)  # (B, E)
    frac_probs = probs.mean(dim=1)
    return e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
