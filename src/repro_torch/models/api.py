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
axes stacked again. With ``rules=`` and a ``mesh=`` that has a model axis
the model is built sharded over it (:func:`sharding_of`): the entry
points below then run tensor-parallel, ``to_reference`` gathers the
blocks, and ``global_cache`` puts a sharded decode cache in the
reference's layout (``held_cache`` the way back). With FSDP rules
(``rules_for_mesh(mesh, fsdp=True)``) the leaves with an ``embed``
dimension are also split over the data axes, with or without a model
axis: each pass gathers a unit's parameters just before the unit runs
(``lm.gathered``). ``param_leaves`` lists the reference's leaves in its
leaf order (sorted keys), each with the model's parameters it stacks; the
optimizers, the gradient trees and the checkpoints work on those leaves.

numpy has no bfloat16: a bfloat16 leaf crosses to numpy as its 16-bit
pattern in a ``|V2`` array, the dtype the reference's own ``np.savez`` of
an ``ml_dtypes.bfloat16`` leaf loads back as (``to_numpy``/``from_numpy``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import collectives
from repro_torch.core.bfs import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import PD, MeshRules, SimMesh
from repro_torch.models import encdec, layers, lm, mamba2


def param_defs(cfg: ModelConfig) -> Dict:
    return encdec.param_defs(cfg) if cfg.family == "audio" else lm.param_defs(cfg)


def build_model(cfg: ModelConfig, device, tp=None, fsdp=None) -> nn.Module:
    """The model's modules, parameters allocated and not yet initialised;
    sharded over the model axis with ``tp`` (a
    :class:`~repro_torch.core.collectives.TensorParallel`) and over the
    data axes with ``fsdp`` (a
    :class:`~repro_torch.core.collectives.FullyShardedData`): the modules
    are built on the meta device, then each parameter is allocated as its
    held blocks (``layers.tp_param``)."""
    mod = encdec.EncDec if cfg.family == "audio" else lm.LM
    if fsdp is None:
        return mod(cfg, device, tp)
    model = mod(cfg, torch.device("meta"), tp)
    defs = param_defs(cfg)
    for mname, sub in model.named_modules():
        for pname in list(sub._parameters):
            parts = (mname.split(".") if mname else []) + [pname]
            pd = shd.tree_get(defs, tuple(p for p in parts if not p.isdigit()))
            nl = sum(p.isdigit() for p in parts)
            pd = PD(pd.shape[nl:], pd.logical[nl:], pd.init, pd.dtype)
            sub._parameters[pname] = layers.tp_param(cfg, pd, device, tp, fsdp)
    model.fsdp = fsdp
    return model


def model_axes(rules: Optional[MeshRules], mesh: Optional[SimMesh]) -> Tuple[str, ...]:
    """The tensor-parallel axes of ``rules`` on ``mesh`` (none without both)."""
    if rules is None or mesh is None:
        return ()
    return tuple(a for a in rules.model if a in mesh.axis_names)


def fsdp_axes(rules: Optional[MeshRules], mesh: Optional[SimMesh]) -> Tuple[str, ...]:
    """The FSDP axes of ``rules`` on ``mesh`` (the batch axes when the rules
    are FSDP's; none without both)."""
    if rules is None or mesh is None:
        return ()
    return tuple(a for a in rules.fsdp if a in mesh.axis_names)


def sharding_of(rules: Optional[MeshRules], mesh: Optional[SimMesh], device, comm=None
                ) -> Tuple[Optional[collectives.TensorParallel],
                           Optional[collectives.FullyShardedData]]:
    """(the :class:`~repro_torch.core.collectives.TensorParallel` of
    ``rules.model``, the
    :class:`~repro_torch.core.collectives.FullyShardedData` of
    ``rules.fsdp``) on ``mesh``, sharing one communicator: ``comm`` (a
    ``DistCommunicator`` of the mesh, one rank a process) or simulated
    ranks on ``device``; None for an axis the mesh lacks."""
    axes, fax = model_axes(rules, mesh), fsdp_axes(rules, mesh)
    if not axes and not fax:
        return None, None
    if comm is None:
        comm = collectives.Communicator(mesh, device)
    elif comm.mesh != mesh:
        raise ValueError(f"the communicator's mesh {comm.mesh} is not {mesh}")
    return (collectives.TensorParallel(comm, axes) if axes else None,
            collectives.FullyShardedData(comm, fax) if fax else None)


def tensor_parallel(rules: Optional[MeshRules], mesh: Optional[SimMesh], device,
                    comm=None) -> Optional[collectives.TensorParallel]:
    """The :class:`~repro_torch.core.collectives.TensorParallel` of
    ``rules.model`` on ``mesh`` (:func:`sharding_of`); None when the mesh
    has no model axis."""
    return sharding_of(MeshRules(model=rules.model) if rules else None, mesh, device,
                       comm)[0]


def check_sharding(model: nn.Module, rules: Optional[MeshRules],
                   mesh: Optional[SimMesh]) -> None:
    """Refuse a model whose layout is not ``rules`` on ``mesh``: a mesh with
    a model axis needs a model sharded over it, FSDP rules a model sharded
    over their data axes (:func:`shard`)."""
    axes, fax = model_axes(rules, mesh), fsdp_axes(rules, mesh)
    tp, fs = getattr(model, "tp", None), getattr(model, "fsdp", None)
    if (axes and (tp is None or tp.axes != axes or tp.comm.mesh != mesh)) or (
            fax and (fs is None or fs.axes != fax or fs.comm.mesh != mesh)):
        raise ValueError(f"the model is not sharded over {axes + fax} of {mesh}: build "
                         f"it with rules= and mesh= (api.init_params, "
                         f"api.from_reference) or api.shard")


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


def local_param_defs(model: nn.Module) -> Dict:
    """The PD tree of what ``model`` holds of each leaf (its stacked
    shape): the reference's :func:`param_defs`, a sharded model's split
    leaves as ``lead + [D?, M?, *block]`` (the held data ranks of an FSDP
    leaf, then the held model ranks, after the layer axes, logical name
    None)."""
    defs = param_defs(model.cfg)
    if getattr(model, "tp", None) is None and getattr(model, "fsdp", None) is None:
        return defs
    out: Dict = {}
    for path, lead, prms in param_leaves(model):
        pd = shd.tree_get(defs, path)
        nh = sum(getattr(prms[0], a, None) is not None for a in ("fsdp_dim", "tp_dim"))
        if nh:
            nl = len(lead)
            pd = PD(lead + tuple(prms[0].shape),
                    pd.logical[:nl] + (None,) * nh + pd.logical[nl:], pd.init, pd.dtype)
        shd.tree_set(out, path, pd)
    return out


def global_leaves(model: nn.Module, tree: Dict) -> Dict:
    """A tree shaped as ``model``'s stacked leaves (gradients, say) in the
    unsharded model's shapes: a sharded model's split leaves, held as
    ``lead + [D?, M?, *block]``, gathered from their blocks."""
    out: Dict = {}
    for path, lead, prms in param_leaves(model):
        t = shd.tree_get(tree, path)
        nl, d = len(lead), getattr(prms[0], "tp_dim", None)
        f = getattr(prms[0], "fsdp_dim", None)
        if f is not None:
            t = model.fsdp.unshard(t.movedim(nl, 0), nl + int(d is not None) + f)
        if d is not None:
            t = model.tp.unshard(t.movedim(nl, 0), nl + d)
        shd.tree_set(out, path, t)
    return out


def held_leaves(model: nn.Module, tree: Dict) -> Dict:
    """The inverse of :func:`global_leaves`: what a sharded ``model`` holds
    of each leaf of an unsharded tree."""
    out: Dict = {}
    for path, lead, prms in param_leaves(model):
        t = shd.tree_get(tree, path)
        nl, d = len(lead), getattr(prms[0], "tp_dim", None)
        f = getattr(prms[0], "fsdp_dim", None)
        if d is not None:
            t = model.tp.shard(t, nl + d).movedim(0, nl)
        if f is not None:
            t = model.fsdp.shard(t, nl + int(d is not None) + f).movedim(0, nl)
        shd.tree_set(out, path, t.contiguous() if d is not None or f is not None else t)
    return out


def _cache_leaves(model: nn.Module, cache: Dict, fn) -> Dict:
    """``cache`` with each split SSM leaf (``state``, ``conv_x``: the only
    decode-cache leaves a sharded model holds as blocks; the KV caches are
    replicated) replaced by ``fn(leaf, split dim, per-layer ndim)``."""
    tp = getattr(model, "tp", None)
    if tp is None or model.cfg.family not in ("ssm", "hybrid"):
        return cache
    dims = mamba2.cache_split_dims(model.cfg, tp)
    ndims = {k: len(pd.shape) for k, pd in mamba2.ssm_cache_defs(model.cfg, 1).items()}

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif dims.get(k) is not None:
                out[k] = fn(v, dims[k], ndims[k])
            else:
                out[k] = v
        return out

    return walk(cache)


def global_cache(model: nn.Module, cache: Dict) -> Dict:
    """A sharded model's decode cache in the reference's layout: the SSM
    leaves held as blocks (``lead + [n_local, *block]``, ``lead`` the layer
    axes) gathered (``TensorParallel.unshard``)."""
    def fn(t, d, nd):
        nl = t.dim() - 1 - nd
        return model.tp.unshard(t.movedim(nl, 0), nl + d)

    return _cache_leaves(model, cache, fn)


def held_cache(model: nn.Module, cache: Dict) -> Dict:
    """The inverse of :func:`global_cache`: what a sharded model holds of a
    decode cache in the reference's layout."""
    def fn(t, d, nd):
        nl = t.dim() - nd
        return model.tp.shard(t, nl + d).movedim(0, nl).contiguous()

    return _cache_leaves(model, cache, fn)


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
    stacked: Dict = {}
    for path, lead, prms in param_leaves(model):
        shd.tree_set(stacked, path, stack_leaf(lead, prms))
    return shd.tree_map(to_numpy, global_leaves(model, stacked))


def _load(model: nn.Module, leaves) -> nn.Module:
    """Fill every parameter from ``leaves``, (path, full stacked array)
    pairs; refuse a tree that does not match the model leaf for leaf."""
    index = _param_index(model)
    tp, fs = getattr(model, "tp", None), getattr(model, "fsdp", None)
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
        split = getattr(targets[0][1], "tp_dim", None)
        fsplit = getattr(targets[0][1], "fsdp_dim", None)
        have = tuple(targets[0][1].shape)
        if fsplit is not None:  # the model-held shape of the data-held blocks
            f = fsplit + 1 + int(split is not None)
            have = have[1:f] + (have[f] * fs.size,) + have[f + 1:]
        if split is not None:  # the global shape of the held blocks
            have = have[1:split + 1] + (have[split + 1] * tp.size,) + have[split + 2:]
        if (tuple(full.shape[:n_lead]) != tuple(1 + max(i[a] for i, _ in targets)
                                               for a in range(n_lead))
                or len(targets) != int(np.prod(full.shape[:n_lead]))
                or want != have):
            raise ValueError(f"leaf {key!r} has shape {tuple(full.shape)}; the "
                             f"{name} model wants {len(targets)} x {have}")
        with torch.no_grad():
            for idx, prm in targets:
                x = (full[idx] if idx else full).to(prm.device)
                if split is not None:
                    x = tp.shard(x, split)
                if fsplit is not None:
                    x = fs.shard(x, fsplit + int(split is not None))
                prm.copy_(x)
        seen.add(path)
    missing = sorted("/".join(p) for p in index if p not in seen)
    if missing:
        raise ValueError(f"parameter tree lacks leaves of the {name} "
                         f"model: {missing}")
    return model


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda", rules=None, mesh=None,
                comm=None) -> nn.Module:
    """A model with seeded weights on ``device`` (the card by default): the
    reference's laws, one ``torch.Generator`` a leaf seeded from ``seed``
    and the leaf's path. Not bit-equal to ``jax.random``. With ``rules`` and
    a ``mesh`` that has a model axis, or FSDP rules, sharded over it
    (:func:`sharding_of`; ``comm`` a ``DistCommunicator`` of the mesh):
    every leaf is drawn whole and its blocks kept, so the shards hold the
    unsharded model's values."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, *sharding_of(rules, mesh, dev, comm))
    return _load(model, shd.iter_init(param_defs(cfg), seed, cfg.param_dtype, dev))


def load_reference(module: nn.Module, params) -> nn.Module:
    """Fill ``module``'s parameters from a reference parameter tree (nested
    dicts of arrays, stacked layers on leading axes) of the same structure;
    refuse a tree that does not match it leaf for leaf."""
    leaves = ((path, np.array(a)) for path, a in shd.tree_leaves_with_path(params))
    return _load(module, leaves)


def from_reference(cfg: ModelConfig, params, *, device="cuda", rules=None, mesh=None,
                   comm=None) -> nn.Module:
    """The JAX package's parameter tree for ``cfg`` (nested dicts of numpy
    arrays) as the port's model on ``device``; sharded as
    :func:`init_params` with ``rules`` and ``mesh``."""
    dev = resolve_device(device)
    return load_reference(build_model(cfg, dev, *sharding_of(rules, mesh, dev, comm)), params)


def shard(model: nn.Module, rules: MeshRules, mesh: SimMesh, comm=None) -> nn.Module:
    """A copy of an unsharded ``model`` sharded over ``mesh``'s model axis,
    and with FSDP rules its data axes (the same values; ``model`` is left
    as it is)."""
    dev = next(model.parameters()).device
    tp, fs = sharding_of(rules, mesh, dev, comm)
    if tp is None and fs is None:
        raise ValueError(f"{mesh} has no model axis or FSDP axes in {rules}")
    out = build_model(model.cfg, dev, tp, fs)
    return _load(out, ((path, stack_leaf(lead, prms)) for path, lead, prms
                       in param_leaves(model)))


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


def train_loss_fn(cfg: ModelConfig, rules=None, mesh=None):
    """The loss of a model on ``mesh`` under ``rules``; with a model axis
    the model must be sharded over it (it then runs tensor-parallel)."""
    mod = encdec if cfg.family == "audio" else lm

    def f(model, batch):
        check_sharding(model, rules, mesh)
        return mod.train_loss(cfg, model, batch)

    return f


def prefill_fn(cfg: ModelConfig, rules=None, mesh=None):
    if cfg.family == "audio":

        def f(model, inputs):
            check_sharding(model, rules, mesh)
            return encdec.prefill(cfg, model, inputs["tokens"], frames=inputs["frames"])

    else:

        def f(model, inputs):
            check_sharding(model, rules, mesh)
            return lm.prefill(cfg, model, inputs["tokens"], patches=inputs.get("patches"))

    return f


def decode_fn(cfg: ModelConfig, rules=None, mesh=None):
    mod = encdec if cfg.family == "audio" else lm

    def f(model, cache, token, pos):
        check_sharding(model, rules, mesh)
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
