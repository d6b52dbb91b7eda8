"""Optimizers from scratch: AdamW and Adafactor (factored second moments).

The port of ``repro.train.optim``. The state is the reference's tree:
nested dicts keyed by the reference's parameter paths, each leaf in the
reference's *stacked* shape (the moments of a per-layer weight are one
``[n_layers, ...]`` tensor), float32, on the model's device; ``count`` is
an int32 scalar. ``apply`` works leaf by leaf on the stacked view of each
parameter (``api.param_leaves``), so Adafactor's factored statistics and
its update's RMS clip are taken over the whole stacked leaf, as the
reference takes them: a per-layer norm scale, ``(d,)`` in the model, is a
factored ``(n_layers, d)`` leaf here. Gradients are trees of the same
shape (``train.step``). Updates are computed in float32 with the
reference's expressions and cast back to the parameter's dtype; the model
and the state are written in place (and returned).

A model sharded over the model axis (``model.tp``) holds each split leaf
as ``[*lead, n_local, *block]`` and its state likewise: the clip's norm
all-reduces the split leaves' squares (each replicated leaf counted once),
Adafactor's means over a split dimension and its update's RMS are local
sums all-reduced over the model axis; :func:`global_state` /
:func:`local_state` convert the state to and from the unsharded model's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import PD, sorted_leaves, tree_get
from repro_torch.models import api


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    state_defs: Callable[[Any], Any]  # param defs -> state defs (PD tree)
    init: Callable[[Any], Any]  # model -> state
    apply: Callable[..., Tuple[Any, Any]]  # (model, grads, state, lr) -> (model, state)


def cosine_lr(step: int, *, peak: float = 3e-4, warmup: int = 100, total: int = 10_000,
              floor: float = 0.1) -> float:
    """Linear warm-up then cosine decay to ``floor * peak``, in float32 as the
    reference computes it (its value as a Python float)."""
    step = torch.tensor(step, dtype=torch.float32)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return float(torch.where(step < warmup, warm, cos))


def global_norm(grads: Dict, model=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each leaf's
    float32 sum of squares. For a sharded ``model`` the split leaves' sums
    are all-reduced over the model axis (one call for all of them) and
    each replicated leaf is counted once."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for _, g in sorted_leaves(grads)))
    axis = shard_axes(model)
    whole = torch.zeros((), dtype=torch.float32, device=_model_device(model))
    per_rank = torch.zeros(tp.n_local, dtype=torch.float32, device=whole.device)
    for path, g in sorted_leaves(grads):
        sq = torch.square(g.float())
        if axis[path] is None:
            whole = whole + torch.sum(sq)
        else:
            per_rank = per_rank + sq.movedim(axis[path], 0).reshape(tp.n_local, -1).sum(1)
    return torch.sqrt(whole + tp.sum_stat(per_rank, 0)[0])


def shard_axes(model) -> Dict:
    """reference path -> the position of the held-ranks axis in the leaf's
    stacked local form (None: replicated)."""
    return {path: (None if prms[0].tp_dim is None else len(lead))
            for path, lead, prms in api.param_leaves(model)}


def clip_by_global_norm(grads: Dict, max_norm: float = 1.0, model=None):
    """-> (the tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm);
    ``model`` sharded: the norm over its shards (:func:`global_norm`)."""
    gn = global_norm(grads, model)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return shd.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _write_back(prms, new: torch.Tensor) -> None:
    """Copy a stacked leaf's new values into its parameters."""
    rows = new.reshape((-1,) + tuple(prms[0].shape))
    for k, prm in enumerate(prms):
        prm.copy_(rows[k])


def from_reference(model, opt_state) -> Dict:
    """The reference's optimizer state (nested dicts of numpy arrays) as the
    port's, on the model's device (a sharded model's: its blocks,
    :func:`local_state`); refuse a tree whose leaves differ from the
    model's optimizer's in path or shape."""
    want = get(model.cfg.optimizer).state_defs(api.param_defs(model.cfg))
    have = {p: tuple(a.shape) for p, a in sorted_leaves(opt_state)}
    need = {p: pd.shape for p, pd in sorted_leaves(want)}
    differ = sorted(p for p in set(have) | set(need) if have.get(p) != need.get(p))
    if differ:
        raise ValueError(f"optimizer state does not match {model.cfg.name}'s "
                         f"{model.cfg.optimizer} at {['/'.join(p) for p in differ[:4]]}")
    dev = _model_device(model)
    return local_state(model, shd.tree_map(lambda a: api.from_numpy(a).to(dev), opt_state))


def _state_leaves(model):
    """(path, global PD, local PD) of every leaf of ``model``'s optimizer
    state."""
    opt = get(model.cfg.optimizer)
    glob = dict(sorted_leaves(opt.state_defs(api.param_defs(model.cfg))))
    return [(p, glob[p], pd) for p, pd in
            sorted_leaves(opt.state_defs(api.local_param_defs(model)))]


def _held_axis(gpd: PD, lpd: PD) -> Optional[int]:
    """Where a local state leaf holds its model ranks: after the layer axes,
    when it has one more dimension than the global leaf."""
    if len(lpd.shape) == len(gpd.shape):
        return None
    ax = 0
    while ax < len(gpd.logical) and gpd.logical[ax] == "layers":
        ax += 1
    return ax


def global_state(model, state: Dict) -> Dict:
    """The optimizer state of a sharded ``model`` as the unsharded model's
    (each statistic gathered from its blocks, or one rank's copy of a
    statistic the spec replicates); ``state`` itself when unsharded."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return state
    out: Dict = {}
    for path, gpd, lpd in _state_leaves(model):
        t = tree_get(state, path)
        ax = _held_axis(gpd, lpd)
        if ax is not None:
            blocks = t.movedim(ax, 0)
            d = tp.split_dim(gpd)
            t = blocks[0] if d is None else tp.unshard(blocks, d)
        shd.tree_set(out, path, t)
    return out


def local_state(model, state: Dict) -> Dict:
    """The inverse of :func:`global_state`: the unsharded model's optimizer
    state as what a sharded ``model`` holds."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return state
    out: Dict = {}
    for path, gpd, lpd in _state_leaves(model):
        t = tree_get(state, path)
        ax = _held_axis(gpd, lpd)
        if ax is not None:
            d = tp.split_dim(gpd)
            blocks = (t.unsqueeze(0).expand((tp.n_local,) + tuple(t.shape)) if d is None
                      else tp.shard(t, d))
            t = blocks.movedim(0, ax).contiguous()
        shd.tree_set(out, path, t)
    return out


def from_placed(model, placed: Dict, mesh, pspecs: Dict) -> Dict:
    """What a sharded ``model`` holds of an optimizer state restored onto
    ``mesh`` (``ckpt.restore(mesh=, pspecs=)``: every leaf the
    ``[mesh.ranks, *shard]`` per-device shards of its ``pspecs`` spec)."""
    glob = {p: shd.gather(t, tree_get(pspecs, p), mesh) for p, t in sorted_leaves(placed)}
    out: Dict = {}
    for p, t in glob.items():
        shd.tree_set(out, p, t)
    return local_state(model, out)


def _initializer(state_defs):
    def init(model) -> Dict:
        """Zero state for ``model`` on its device (a sharded model's blocks)."""
        return shd.tree_init(state_defs(api.local_param_defs(model)), 0,
                             device=_model_device(model))

    return init


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_state_defs(pdefs):
    def f32(pd):
        return PD(pd.shape, pd.logical, "zeros", dtype="float32")

    return {"m": shd.tree_map(f32, pdefs), "v": shd.tree_map(f32, pdefs),
            "count": PD((), (), "zeros", dtype="int32")}


@torch.no_grad()
def _adamw_apply(model, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    cnt = state["count"] + 1
    t = cnt.float()
    for path, lead, prms in api.param_leaves(model):
        p = api.stack_leaf(lead, prms)
        g = tree_get(grads, path).float()
        m_old, v_old = tree_get(state["m"], path), tree_get(state["v"], path)
        m = b1 * m_old + (1 - b1) * g
        v = b2 * v_old + (1 - b2) * g * g
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        step = mh / (torch.sqrt(vh) + eps) + wd * p.float()
        _write_back(prms, (p.float() - lr * step).to(p.dtype))
        m_old.copy_(m)
        v_old.copy_(v)
    state["count"] = cnt
    return model, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored second moments, no momentum
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def _adafactor_state_defs(pdefs):
    def leaf(pd: PD):
        if _factored(pd.shape):
            return {
                "vr": PD(pd.shape[:-1], pd.logical[:-1], "zeros", dtype="float32"),
                "vc": PD(pd.shape[:-2] + pd.shape[-1:], pd.logical[:-2] + pd.logical[-1:],
                         "zeros", dtype="float32"),
            }
        return {"v": PD(pd.shape, pd.logical, "zeros", dtype="float32")}

    return {"f": shd.tree_map(leaf, pdefs), "count": PD((), (), "zeros", dtype="int32")}


@torch.no_grad()
def _adafactor_apply(model, grads, state, lr, **kw):
    cnt = state["count"] + 1
    t = cnt.float()
    beta2 = 1.0 - t ** -0.8
    d = kw.get("d", 1.0)
    eps = 1e-30
    wd = kw.get("wd", 0.0)
    tp = getattr(model, "tp", None)
    for path, lead, prms in api.param_leaves(model):
        p = api.stack_leaf(lead, prms)
        g = tree_get(grads, path).float()
        s = tree_get(state["f"], path)
        g2 = g * g + eps
        split = getattr(prms[0], "tp_dim", None)
        if split is not None:
            u, new = _adafactor_sharded(tp, g, g2, s, beta2, len(lead), split, eps)
        elif _factored(p.shape):
            vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (vr[..., None] / (vr.mean(dim=-1, keepdim=True)[..., None] + eps)
                     ) * vc[..., None, :]
            u = g * torch.rsqrt(denom + eps)
            new = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + eps)
            new = {"v": v}
        if split is not None:
            n = g.shape[len(lead)]
            sums = (u * u).movedim(len(lead), 0).reshape(n, -1).sum(1)
            mean = tp.sum_stat(sums, 0) / (u.numel() // n * tp.size)
            rms = torch.sqrt(mean + eps).reshape((1,) * len(lead) + (n,) + (1,) * (u.dim() - len(lead) - 1))
        else:
            rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / d, min=1.0)
        newp = p.float() - lr * u - lr * wd * p.float()
        _write_back(prms, newp.to(p.dtype))
        for k, val in new.items():
            s[k].copy_(val)
    state["count"] = cnt
    return model, state


def _adafactor_sharded(tp, g, g2, s, beta2, na: int, split: int, eps: float):
    """Adafactor's factored update of a split leaf, held as ``[*lead, n,
    *block]`` (``na`` lead axes; ``split`` the block's split dimension):
    each mean over the split dimension is a local sum all-reduced over the
    model axis, divided by the global length. -> (update, new state)."""
    nd = g.dim()
    sd = na + 1 + split  # the split dimension in the held form

    def mean(t, dim, t_split):
        dim %= t.dim()
        if dim != t_split:
            return t.mean(dim=dim)
        return tp.sum_stat(t.sum(dim=dim), na) / (t.shape[dim] * tp.size)

    if nd - na - 1 < 2:
        raise ValueError(f"a split leaf of {nd - na - 1} block dims is not factored here")
    vr = beta2 * s["vr"] + (1 - beta2) * mean(g2, -1, sd)
    vc = beta2 * s["vc"] + (1 - beta2) * mean(g2, -2, sd)
    vr_split = sd if sd < nd - 1 else None
    row = mean(vr, -1, vr_split)
    denom = (vr[..., None] / (row[..., None, None] + eps)) * vc[..., None, :]
    return g * torch.rsqrt(denom + eps), {"vr": vr, "vc": vc}


ADAMW = Optimizer("adamw", _adamw_state_defs, _initializer(_adamw_state_defs), _adamw_apply)
ADAFACTOR = Optimizer("adafactor", _adafactor_state_defs,
                      _initializer(_adafactor_state_defs), _adafactor_apply)


def get(name: str) -> Optimizer:
    return {"adamw": ADAMW, "adafactor": ADAFACTOR}[name]


def tp_calls(model) -> list:
    """The byte model of a sharded ``model``'s clip and optimizer update:
    the model-axis all-reduces one rank makes, as (kind, operand bytes) in
    order (the clip's one call for the split leaves' squares, then
    Adafactor's per split leaf: each mean over the split dimension and the
    update's RMS)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return []
    out = []
    leaves = [(lead, prms[0]) for _, lead, prms in api.param_leaves(model)]
    if any(p.tp_dim is not None for _, p in leaves):
        out.append(("all-reduce", 4))
    if model.cfg.optimizer != "adafactor":
        return out
    for lead, prm in leaves:
        if prm.tp_dim is None:
            continue
        block = tuple(lead) + tuple(prm.shape[1:])  # one rank's leaf
        nd, sd = len(block), len(lead) + prm.tp_dim

        def without(*dims):
            return 4 * math.prod(n for i, n in enumerate(block) if i not in dims)

        if sd == nd - 1:
            out.append(("all-reduce", without(nd - 1)))
        if sd == nd - 2:
            out.append(("all-reduce", without(nd - 2)))
            out.append(("all-reduce", without(nd - 1, nd - 2)))
        out.append(("all-reduce", 4))
    return out
