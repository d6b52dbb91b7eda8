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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

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


def global_norm(grads: Dict) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in sorted_leaves(grads)))


def clip_by_global_norm(grads: Dict, max_norm: float = 1.0):
    """-> (the tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    gn = global_norm(grads)
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
    port's, on the model's device; refuse a tree whose leaves differ from
    the model's optimizer's in path or shape."""
    want = get(model.cfg.optimizer).state_defs(api.param_defs(model.cfg))
    have = {p: tuple(a.shape) for p, a in sorted_leaves(opt_state)}
    need = {p: pd.shape for p, pd in sorted_leaves(want)}
    differ = sorted(p for p in set(have) | set(need) if have.get(p) != need.get(p))
    if differ:
        raise ValueError(f"optimizer state does not match {model.cfg.name}'s "
                         f"{model.cfg.optimizer} at {['/'.join(p) for p in differ[:4]]}")
    dev = _model_device(model)
    return shd.tree_map(lambda a: api.from_numpy(a).to(dev), opt_state)


def _initializer(state_defs):
    def init(model) -> Dict:
        """Zero state for ``model`` on its device."""
        return shd.tree_init(state_defs(api.param_defs(model.cfg)), 0,
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
    for path, lead, prms in api.param_leaves(model):
        p = api.stack_leaf(lead, prms)
        g = tree_get(grads, path).float()
        s = tree_get(state["f"], path)
        g2 = g * g + eps
        if _factored(p.shape):
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
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / d, min=1.0)
        newp = p.float() - lr * u - lr * wd * p.float()
        _write_back(prms, newp.to(p.dtype))
        for k, val in new.items():
            s[k].copy_(val)
    state["count"] = cnt
    return model, state


ADAMW = Optimizer("adamw", _adamw_state_defs, _initializer(_adamw_state_defs), _adamw_apply)
ADAFACTOR = Optimizer("adafactor", _adafactor_state_defs,
                      _initializer(_adafactor_state_defs), _adafactor_apply)


def get(name: str) -> Optimizer:
    return {"adamw": ADAMW, "adafactor": ADAFACTOR}[name]
