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
FSDP (``model.fsdp``) adds the held data ranks in front of the model
ranks, ``[*lead, D, M?, *block]``, and every such sum over the data axes
too; a state leaf holds the held axes of its parameter, a copy a rank
where the statistic is not split over an axis (:func:`local_state_defs`).
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
    are all-reduced over the axes that split them, each replicated leaf
    counted once: FSDP's first (one call over the data axes for the
    leaves split over them, with the model axis's blocks and without),
    then the model axis's (one call)."""
    tp, fs = getattr(model, "tp", None), getattr(model, "fsdp", None)
    if tp is None and fs is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for _, g in sorted_leaves(grads)))
    held = held_pars(model)
    dev = _model_device(model)
    nd, nm = (fs.n_local if fs else 1), (tp.n_local if tp else 1)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    per_m = torch.zeros(nm, dtype=torch.float32, device=dev)
    per_d = torch.zeros(nd, dtype=torch.float32, device=dev)
    per_dm = torch.zeros(nd, nm, dtype=torch.float32, device=dev)
    for path, g in sorted_leaves(grads):
        pars, na = held[path]
        sq = _front(torch.square(g.float()), na, len(pars))
        kinds = tuple(p is fs for p in pars)
        if not pars:
            whole = whole + torch.sum(sq)
        elif kinds == (False,):
            per_m = per_m + sq.reshape(nm, -1).sum(1)
        elif kinds == (True,):
            per_d = per_d + sq.reshape(nd, -1).sum(1)
        else:
            per_dm = per_dm + sq.reshape(nd, nm, -1).sum(-1)
    if fs is not None and any(p is fs for pars, _ in held.values() for p in pars):
        if tp is None:
            whole = whole + fs.sum_stat(per_d, 0)[0]
        else:
            stat = torch.stack([per_dm, per_d[:, None].expand(nd, nm)], dim=-1)
            summed = fs.sum_stat(stat, 0, nm)[0]  # [nm, 2]
            per_m = per_m + summed[:, 0]
            whole = whole + summed[0, 1]
    if tp is not None and any(p is tp for pars, _ in held.values() for p in pars):
        whole = whole + tp.sum_stat(per_m, 0)[0]
    return torch.sqrt(whole)


def held_pars(model) -> Dict:
    """reference path -> (the held axes' parallelisms in held order: the
    ``FullyShardedData`` then the ``TensorParallel`` of those that split
    the leaf, the number of layer axes in front of them)."""
    out = {}
    for path, lead, prms in api.param_leaves(model):
        pars = []
        if getattr(prms[0], "fsdp_dim", None) is not None:
            pars.append(model.fsdp)
        if getattr(prms[0], "tp_dim", None) is not None:
            pars.append(model.tp)
        out[path] = (tuple(pars), len(lead))
    return out


def _front(t: torch.Tensor, at: int, nh: int) -> torch.Tensor:
    """``t``'s ``nh`` held axes, at ``at``, moved to the front."""
    if not nh:
        return t
    return t.movedim(tuple(range(at, at + nh)), tuple(range(nh)))


def _back(t: torch.Tensor, at: int, nh: int) -> torch.Tensor:
    """The inverse of :func:`_front`."""
    if not nh:
        return t
    return t.movedim(tuple(range(nh)), tuple(range(at, at + nh)))


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


def _sharded(model) -> bool:
    return getattr(model, "tp", None) is not None or getattr(model, "fsdp", None) is not None


def _param_path(state_path: Tuple[str, ...], name: str) -> Tuple[str, ...]:
    """The parameter path a state leaf mirrors (AdamW's ``m/<path>``,
    Adafactor's ``f/<path>/vr``)."""
    return state_path[1:-1] if name == "adafactor" else state_path[1:]


def _lead(pd: PD) -> int:
    """The layer axes in front of a (global) state leaf: where its held axes go."""
    ax = 0
    while ax < len(pd.logical) and pd.logical[ax] == "layers":
        ax += 1
    return ax


def _state_leaves(model):
    """(path, global PD, local PD, held parallelisms) of every leaf of
    ``model``'s optimizer state: a leaf of a split parameter holds that
    parameter's held axes after its own layer axes, and along each
    dimension its spec splits the block."""
    opt = get(model.cfg.optimizer)
    held = held_pars(model) if _sharded(model) else {}
    mesh = (model.tp or model.fsdp).comm.mesh if held else None
    out = []
    for p, gpd in sorted_leaves(opt.state_defs(api.param_defs(model.cfg))):
        pars = held.get(_param_path(p, opt.name), ((), 0))[0]
        lpd = gpd
        if pars:
            rules = shd.MeshRules(model=model.tp.axes if model.tp in pars else (),
                                  fsdp=model.fsdp.axes if model.fsdp in pars else ())
            block = shd.held_block(gpd, rules, mesh)[0]
            ax = _lead(gpd)
            lpd = PD(block[:ax] + tuple(q.n_local for q in pars) + block[ax:],
                     gpd.logical[:ax] + (None,) * len(pars) + gpd.logical[ax:], gpd.init,
                     gpd.dtype)
        out.append((p, gpd, lpd, pars))
    return out


def local_state_defs(model) -> Dict:
    """The PD tree of what ``model`` holds of its optimizer state."""
    out: Dict = {}
    for p, _, lpd, _ in _state_leaves(model):
        shd.tree_set(out, p, lpd)
    return out


def global_state(model, state: Dict) -> Dict:
    """The optimizer state of a sharded ``model`` as the unsharded model's
    (each statistic gathered from its blocks, or one rank's copy of a
    statistic the spec replicates); ``state`` itself when unsharded."""
    if not _sharded(model):
        return state
    out: Dict = {}
    for path, gpd, _, pars in _state_leaves(model):
        t = _front(tree_get(state, path), _lead(gpd), len(pars))
        for k in reversed(range(len(pars))):  # the last held axis first
            blocks = t.movedim(k, 0)
            d = pars[k].split_dim(gpd)
            t = blocks[0] if d is None else pars[k].unshard(blocks, k + d)
        shd.tree_set(out, path, t)
    return out


def local_state(model, state: Dict) -> Dict:
    """The inverse of :func:`global_state`: the unsharded model's optimizer
    state as what a sharded ``model`` holds."""
    if not _sharded(model):
        return state
    out: Dict = {}
    for path, gpd, _, pars in _state_leaves(model):
        t = tree_get(state, path)
        for k, q in enumerate(pars):
            d = q.split_dim(gpd)
            blocks = (t.unsqueeze(0).expand((q.n_local,) + tuple(t.shape)) if d is None
                      else q.shard(t, k + d))
            t = blocks.movedim(0, k)
        if pars:
            t = _back(t, _lead(gpd), len(pars)).contiguous()
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
        return shd.tree_init(local_state_defs(model), 0, device=_model_device(model))

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
    held = held_pars(model) if _sharded(model) else {}
    for path, lead, prms in api.param_leaves(model):
        p = api.stack_leaf(lead, prms)
        g = tree_get(grads, path).float()
        s = tree_get(state["f"], path)
        g2 = g * g + eps
        pars = held.get(path, ((), 0))[0]
        if pars:
            u, new = _adafactor_held(model, pars, prms[0], g, g2, s, beta2, len(lead), eps, d)
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
        if not pars:
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u) + eps) / d, min=1.0)
        newp = p.float() - lr * u - lr * wd * p.float()
        _write_back(prms, newp.to(p.dtype))
        for k, val in new.items():
            s[k].copy_(val)
    state["count"] = cnt
    return model, state


def _adafactor_held(model, pars, prm, g, g2, s, beta2, na: int, eps: float, d: float):
    """Adafactor's update of a split leaf, held as ``[*lead, *held, *block]``
    (``na`` lead axes; ``pars`` the held axes' parallelisms), its RMS clip
    applied: the unsplit expressions on the held axes moved to the front,
    each mean over a split dimension a local sum all-reduced over the axes
    that split it, divided by the global length. -> (update, new state)."""
    nh = len(pars)
    counts = [q.n_local for q in pars]
    split = {}  # global dimension -> (held axis, parallelism)
    for k, q in enumerate(pars):
        dim = prm.fsdp_dim if q is model.fsdp else prm.tp_dim
        split[na + dim] = (k, q)

    def mean(t, dim, spl):
        if dim not in spl:
            return t.mean(dim=nh + dim)
        k, q = spl[dim]
        others = math.prod(c for i, c in enumerate(counts) if i != k)
        return q.sum_stat(t.sum(dim=nh + dim), k, others) / (t.shape[nh + dim] * q.size)

    gf, g2f = _front(g, na, nh), _front(g2, na, nh)
    nd = g.dim() - nh  # the global leaf's dimensions
    if nd >= 2:
        vr_old = _front(s["vr"], na, nh)
        vc_old = _front(s["vc"], min(na, nd - 2), nh)
        vr = beta2 * vr_old + (1 - beta2) * mean(g2f, nd - 1, split)
        vc = beta2 * vc_old + (1 - beta2) * mean(g2f, nd - 2, split)
        row = mean(vr, nd - 2, {j: v for j, v in split.items() if j != nd - 1})
        denom = (vr[..., None] / (row[..., None, None] + eps)) * vc[..., None, :]
        u = gf * torch.rsqrt(denom + eps)
        new = {"vr": _back(vr, na, nh), "vc": _back(vc, min(na, nd - 2), nh)}
    else:
        v = beta2 * _front(s["v"], na, nh) + (1 - beta2) * g2f
        u = gf * torch.rsqrt(v + eps)
        new = {"v": _back(v, na, nh)}
    sums = (u * u).reshape(tuple(counts) + (-1,)).sum(-1)
    total = math.prod(q.size for q in pars) * (u.numel() // math.prod(counts))
    for k, q in enumerate(pars):
        sums = q.sum_stat(sums, k, math.prod(c for i, c in enumerate(counts) if i != k))
    rms = torch.sqrt(sums / total + eps).reshape(tuple(counts) + (1,) * nd)
    u = u / torch.clamp(rms / d, min=1.0)
    return _back(u, na, nh), new


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
    return _calls(model, getattr(model, "tp", None))


def fsdp_calls(model) -> list:
    """:func:`tp_calls` over the data axes: FSDP's all-reduces (the clip's
    call carries two statistics a rank beside a model axis)."""
    return _calls(model, getattr(model, "fsdp", None))


def _calls(model, par) -> list:
    if par is None:
        return []
    held = held_pars(model)
    out = []
    if any(par in pars for pars, _ in held.values()):
        two = par is model.fsdp and model.tp is not None
        out.append(("all-reduce", 8 if two else 4))
    if model.cfg.optimizer != "adafactor":
        return out
    for path, lead, prms in api.param_leaves(model):
        pars, na = held[path]
        if par not in pars:
            continue
        prm = prms[0]
        block = tuple(lead) + tuple(prm.shape[len(pars):])  # one rank's leaf
        nd = len(block)
        sd = na + (prm.fsdp_dim if par is model.fsdp else prm.tp_dim)

        def without(*dims):
            return 4 * math.prod(n for i, n in enumerate(block) if i not in dims)

        if nd >= 2 and sd == nd - 1:
            out.append(("all-reduce", without(nd - 1)))
        if nd >= 2 and sd == nd - 2:
            out.append(("all-reduce", without(nd - 2)))
            out.append(("all-reduce", without(nd - 1, nd - 2)))
        out.append(("all-reduce", 4))
    return out
