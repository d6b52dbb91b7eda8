"""Family-dispatching model API.

The port of ``repro.models.api``. One entry point per step kind, uniform
across all ten architectures:

  * ``train_loss_fn(cfg)``   -> f(model, batch)              (the loss's value)
  * ``prefill_fn(cfg)``      -> f(model, inputs)             -> (logits, cache, pos)
  * ``decode_fn(cfg)``       -> f(model, cache, token, pos)  -> (logits, cache)

plus the declarative descriptors ``param_defs`` / ``input_defs`` /
``cache_defs`` (nested dicts of PD, equal to the reference's).

The model is an ``nn.Module`` (``lm.LM`` or ``encdec.EncDec``) on an
explicit device: ``init_params(cfg, seed, device=...)`` draws its weights
from seeded ``torch.Generator``s, and ``from_reference(cfg, params,
device=...)`` carries the JAX package's parameter tree (as numpy arrays)
into it. Both default to the card and raise when there is none.
``to_reference(model)`` is the way back: the reference's tree, its layer
axes stacked again. ``param_leaves`` lists the reference's leaves in its
leaf order (sorted keys), each with the model's parameters it stacks; the
optimizers, the gradient trees and the checkpoints work on those leaves.

numpy has no bfloat16: a bfloat16 leaf crosses to numpy as its 16-bit
pattern in a ``|V2`` array, the dtype the reference's own ``np.savez`` of
an ``ml_dtypes.bfloat16`` leaf loads back as (``to_numpy``/``from_numpy``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.bfs import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import PD
from repro_torch.models import encdec, lm


def param_defs(cfg: ModelConfig) -> Dict:
    return encdec.param_defs(cfg) if cfg.family == "audio" else lm.param_defs(cfg)


def build_model(cfg: ModelConfig, device) -> nn.Module:
    """The model's modules, parameters allocated and not yet initialised."""
    mod = encdec.EncDec if cfg.family == "audio" else lm.LM
    return mod(cfg, device)


def _param_index(model: nn.Module) -> Dict[Tuple[str, ...], list]:
    """reference path -> [(stacked index, parameter)]: a parameter's name is
    the reference's path with its stacked axes as ModuleList indices."""
    index: Dict[Tuple[str, ...], list] = {}
    for name, prm in model.named_parameters():
        parts = name.split(".")
        path = tuple(p for p in parts if not p.isdigit())
        idx = tuple(int(p) for p in parts if p.isdigit())
        index.setdefault(path, []).append((idx, prm))
    return index


Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], List[nn.Parameter]]


def param_leaves(model: nn.Module) -> List[Leaf]:
    """(reference path, stacked lead shape, parameters in row-major order of
    their stacked index) of every leaf of the reference's parameter tree, in
    its leaf order: sorted keys, as ``jax.tree.leaves`` orders a dict."""
    out = []
    for path, parts in sorted(_param_index(model).items()):
        parts = sorted(parts, key=lambda t: t[0])
        lead = tuple(1 + max(i[a] for i, _ in parts) for a in range(len(parts[0][0])))
        out.append((path, lead, [prm for _, prm in parts]))
    return out


def stack_leaf(lead: Tuple[int, ...], prms: List[torch.Tensor]) -> torch.Tensor:
    """The reference's leaf of ``prms``: stacked on the lead axes (a copy),
    or the one parameter itself when the leaf has no layer axis."""
    if not lead:
        return prms[0]
    return torch.stack(list(prms)).reshape(lead + tuple(prms[0].shape))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 as its bits in ``|V2``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a) -> torch.Tensor:
    """The inverse of :func:`to_numpy`, a copy: a ``|V2`` array (or an
    ``ml_dtypes.bfloat16`` one) is bfloat16 bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_reference(model: nn.Module) -> Dict:
    """The reference's parameter tree of ``model``: nested dicts of numpy
    arrays keyed by its paths, the layer axes stacked again (the inverse of
    :func:`from_reference`)."""
    tree: Dict = {}
    for path, lead, prms in param_leaves(model):
        shd.tree_set(tree, path, to_numpy(stack_leaf(lead, prms)))
    return tree


def _load(model: nn.Module, leaves) -> nn.Module:
    """Fill every parameter from ``leaves``, (path, full stacked array)
    pairs; refuse a tree that does not match the model leaf for leaf."""
    index = _param_index(model)
    name = f"{model.cfg.name} {type(model).__name__}"
    seen = set()
    for path, full in leaves:
        key = "/".join(path)
        if path not in index:
            raise ValueError(f"parameter tree has leaf {key!r}, which the "
                             f"{name} model does not")
        if not isinstance(full, torch.Tensor):
            full = from_numpy(full)
        targets = index[path]
        n_lead = len(targets[0][0])
        want = tuple(full.shape[n_lead:])
        if (tuple(full.shape[:n_lead]) != tuple(1 + max(i[a] for i, _ in targets)
                                               for a in range(n_lead))
                or len(targets) != int(np.prod(full.shape[:n_lead]))
                or want != tuple(targets[0][1].shape)):
            raise ValueError(f"leaf {key!r} has shape {tuple(full.shape)}; the "
                             f"{name} model wants {len(targets)} x "
                             f"{tuple(targets[0][1].shape)}")
        with torch.no_grad():
            for idx, prm in targets:
                prm.copy_(full[idx] if idx else full)
        seen.add(path)
    missing = sorted("/".join(p) for p in index if p not in seen)
    if missing:
        raise ValueError(f"parameter tree lacks leaves of the {name} "
                         f"model: {missing}")
    return model


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> nn.Module:
    """A model with seeded weights on ``device`` (the card by default): the
    reference's laws, one ``torch.Generator`` a leaf seeded from ``seed``
    and the leaf's path. Not bit-equal to ``jax.random``."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    return _load(model, shd.iter_init(param_defs(cfg), seed, cfg.param_dtype, dev))


def load_reference(module: nn.Module, params) -> nn.Module:
    """Fill ``module``'s parameters from a reference parameter tree (nested
    dicts of arrays, stacked layers on leading axes) of the same structure;
    refuse a tree that does not match it leaf for leaf."""
    leaves = ((path, np.array(a)) for path, a in shd.tree_leaves_with_path(params))
    return _load(module, leaves)


def from_reference(cfg: ModelConfig, params, *, device="cuda") -> nn.Module:
    """The JAX package's parameter tree for ``cfg`` (nested dicts of numpy
    arrays) as the port's model on ``device``."""
    return load_reference(build_model(cfg, resolve_device(device)), params)


def input_defs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Step inputs (excluding params/cache) as PD descriptors."""
    b, l = shape.global_batch, shape.seq_len

    def tok(ln):
        return PD((b, ln), ("batch", None), "zeros", dtype="int32")

    if shape.kind in ("train", "prefill"):
        d: Dict = {}
        if cfg.family == "audio":
            d["frames"] = PD(
                (b, cfg.n_frames, cfg.d_model), ("batch", None, "embed"), "normal"
            )
            d["tokens"] = tok(l)
        elif cfg.family == "vlm":
            d["patches"] = PD(
                (b, cfg.n_patches, cfg.patch_dim), ("batch", None, None), "normal"
            )
            d["tokens"] = tok(l - cfg.n_patches)
        else:
            d["tokens"] = tok(l)
        if shape.kind == "train":
            d["labels"] = PD(d["tokens"].shape, ("batch", None), "zeros", dtype="int32")
        return d
    # decode: one new token against a seq_len cache
    return {
        "token": PD((b, 1), ("batch", None), "zeros", dtype="int32"),
        "pos": PD((), (), "zeros", dtype="int32"),
    }


def cache_defs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    long_ctx = shape.global_batch == 1
    mk = encdec.decode_cache_defs if cfg.family == "audio" else lm.decode_cache_defs
    return mk(cfg, shape.global_batch, shape.seq_len, long_ctx)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def train_loss_fn(cfg: ModelConfig):
    mod = encdec if cfg.family == "audio" else lm

    def f(model, batch):
        return mod.train_loss(cfg, model, batch)

    return f


def prefill_fn(cfg: ModelConfig):
    if cfg.family == "audio":

        def f(model, inputs):
            return encdec.prefill(cfg, model, inputs["tokens"], frames=inputs["frames"])

    else:

        def f(model, inputs):
            return lm.prefill(cfg, model, inputs["tokens"], patches=inputs.get("patches"))

    return f


def decode_fn(cfg: ModelConfig):
    mod = encdec if cfg.family == "audio" else lm

    def f(model, cache, token, pos):
        return mod.decode_step(cfg, model, cache, token, pos)

    return f


# ---------------------------------------------------------------------------
# Parameter accounting (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """total / active / embedding parameter counts (active: MoE top-k only)."""
    total = active = embed = 0
    frac = (cfg.experts_per_token / cfg.n_experts) if cfg.n_experts else 1.0
    for keys, pd in shd.tree_leaves_with_path(param_defs(cfg)):
        n = int(np.prod(pd.shape))
        total += n
        if "embed" in keys or "head" in keys:
            embed += n
            continue
        is_expert = any(k in ("wi", "wg", "wo") for k in keys) and "moe" in keys
        active += int(n * frac) if is_expert else n
    return {"total": total, "active": active, "embed": embed}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed this step."""
    n = param_counts(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len  # forward only
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
