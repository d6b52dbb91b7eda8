"""Train-step builders (the port of ``repro.train.step``).

Two distribution paths:

* ``build_train_step`` — the whole batch on one device: the reference's
  GSPMD step, whose compiler-scheduled all-reduce has no second device to
  sync with here; with ``mesh=`` and ``rules=`` whose model axis shards
  the model, tensor-parallel over it.
* ``build_train_step_butterfly`` — the paper's communication pattern as
  the gradient sync over the ``rules.batch`` axes of a
  :class:`~repro_torch.dist.sharding.SimMesh` (hierarchically when there
  are two, e.g. ``("pod", "data")``). The global batch splits into P
  contiguous row shards, as ``P("data")`` shards rows. On simulated ranks
  each rank's backward runs in turn into its row of ``[P, ...]`` gradient
  buffers; :func:`~repro_torch.core.collectives.sync_leaf` (``method`` ∈
  butterfly | rabenseifner | all_to_all | xla_psum, ``fanout``; or the
  int8 wire) merges them leaf by leaf through a ``Communicator``, which
  counts each rank's bytes, and frees each stack. Clip and optimizer then
  apply to rank 0's copy, as the reference's ``out_specs=P()`` takes every
  rank to hold the same value: at fanout 2 the ranks' copies are
  bit-identical (``a + b == b + a``); where the fold order differs by rank
  (fanout 4, ``all_to_all``, ``xla_psum``) the metric ``rank_spread`` is
  the largest difference between ranks. Given a
  :class:`~repro_torch.dist.process.DistCommunicator`, the same body runs
  one rank a process: each process takes its own rows, syncs over
  ``torch.distributed`` and applies its own copy; ``rank_spread`` is then
  left out (a comparison across processes would ship every gradient once
  more; compare the processes' parameters instead). Requires non-FSDP
  rules (refused). With a model axis in ``rules`` the model axis stays
  inside, as the reference's ``shard_map`` keeps it: each data group's
  backward runs tensor-parallel and each model rank's shard is synced
  over the data axes (``_butterfly_tp``).

Gradients are trees keyed by the reference's parameter paths, in its
stacked shapes (``api.param_leaves``). With ``microbatches == 1`` they are
in the parameter dtype; with more, each microbatch's gradient is one
``torch.autograd.grad``, cast to ``cfg.grad_accum_dtype`` and added in
order (never ``.grad`` accumulation, which would sum in the parameter
dtype), then scaled by ``1 / microbatches``. A step is
``(model, opt_state, batch, step_idx) -> (model, opt_state, metrics)``;
the model and the state are updated in place.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import DTYPES, MeshRules, SimMesh, sorted_leaves, tree_get, tree_set
from repro_torch.models import api, encdec, lm
from repro_torch.train import optim


def _split_batch(batch: Dict, n: int):
    """``n`` microbatches of contiguous rows."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
    m = rows // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


@contextlib.contextmanager
def _recording(prms):
    """Autograd records the parameters inside the block only: the model is
    built with gradients off, so serving builds no graph."""
    for p in prms:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in prms:
            p.requires_grad_(False)


def grad_buffers(model, microbatches: int, accum_dtype, lead=()) -> Dict:
    """Zeroed gradient trees in the reference's stacked shapes (with extra
    ``lead`` axes): the accumulation dtype when microbatching, else each
    parameter's dtype."""
    out: Dict = {}
    for path, stack, prms in api.param_leaves(model):
        dtype = accum_dtype if microbatches > 1 else prms[0].dtype
        tree_set(out, path, torch.zeros(tuple(lead) + stack + tuple(prms[0].shape),
                                        dtype=dtype, device=prms[0].device))
    return out


def _grads_of(loss_fn, model, batch: Dict, microbatches: int, accum_dtype=torch.float32,
              out: Optional[Dict] = None):
    """-> (loss, grads): the loss's value and its gradient tree, averaged
    over ``microbatches``. ``out`` (zeroed buffers of :func:`grad_buffers`,
    e.g. one rank's row of the butterfly step's stacks) takes the result."""
    leaves = api.param_leaves(model)
    prms = [p for _, _, ps in leaves for p in ps]
    n = max(microbatches, 1)
    if out is None:
        out = grad_buffers(model, n, accum_dtype)
    loss = None
    with _recording(prms):
        for mb in _split_batch(batch, n):
            value = loss_fn(model, mb)
            grads = iter(torch.autograd.grad(value, prms))
            loss = value.detach() if loss is None else loss + value.detach()
            for path, _, ps in leaves:
                buf = tree_get(out, path).view((-1,) + tuple(ps[0].shape))
                for k in range(len(ps)):
                    g = next(grads)
                    if n == 1:
                        buf[k].copy_(g)
                    else:
                        buf[k].add_(g.to(buf.dtype))
            del grads, value
    if n > 1:
        inv = 1.0 / n
        loss = loss * inv
        for _, buf in sorted_leaves(out):
            buf.copy_(buf.float() * inv)
    return loss, out


def build_train_step(cfg: ModelConfig, *, mesh: Optional[SimMesh] = None,
                     rules: Optional[MeshRules] = None, microbatches: int = 1,
                     clip_norm: float = 1.0, lr_kw: Optional[Dict] = None):
    """The GSPMD train step: (model, opt_state, batch, step_idx) -> ...

    Without a model axis the whole batch runs on the model's device. With
    ``mesh`` and ``rules`` whose model axis splits the model (built with
    them, ``api.init_params(..., rules=, mesh=)``), the step runs
    tensor-parallel: on simulated ranks the global batch passes at once
    (the data axes' gradient all-reduce is then the sum autograd takes),
    under a ``DistCommunicator`` each process takes its data group's rows
    of the global batch, the loss's sums and every gradient all-reduced
    over the data axes. With FSDP rules (the model built with them) the
    leaves split over the data axes are gathered unit by unit and their
    gradients reduce-scattered by the pass itself
    (``collectives.FullyShardedData``), with or without a model axis: only
    the leaves held whole are all-reduced over the data axes."""
    loss_fn = api.train_loss_fn(cfg, rules, mesh)
    opt = optim.get(cfg.optimizer)
    lr_kw = lr_kw or {}
    accum = DTYPES[cfg.grad_accum_dtype]

    def step(model, opt_state, batch, step_idx):
        tp, fs = getattr(model, "tp", None), getattr(model, "fsdp", None)
        rows = next((par for par in (tp, fs) if par is not None and par.split_rows), None)
        if rows is not None:  # this process's data group's rows
            group = int(rows.comm.mesh.group_index(rows.comm.ranks, _data_axes(model))[0])
            batch = _split_batch(batch, rows.comm.group_size(_data_axes(model)))[group]
        loss, grads = _grads_of(loss_fn, model, batch, microbatches, accum)
        if rows is not None:  # the leaves FSDP splits were reduce-scattered
            for path, _, prms in api.param_leaves(model):
                if getattr(prms[0], "fsdp_dim", None) is None:
                    tree_set(grads, path, rows.data_sum(tree_get(grads, path)))
        grads, gnorm = optim.clip_by_global_norm(grads, clip_norm, model)
        lr = optim.cosine_lr(step_idx, **lr_kw)
        model, opt_state = opt.apply(model, grads, opt_state, lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


def _data_axes(model):
    """The axes a sharded model's data groups lie on."""
    tp = getattr(model, "tp", None)
    return tp.rest if tp is not None else model.fsdp.axes


def build_train_step_butterfly(
    cfg: ModelConfig,
    mesh: SimMesh,
    rules: MeshRules,
    *,
    method: str = "butterfly",
    fanout: int = 2,
    microbatches: int = 1,
    clip_norm: float = 1.0,
    compress: Optional[str] = None,  # None | "int8"
    lr_kw: Optional[Dict] = None,
    comm: Optional[collectives.Communicator] = None,
):
    """Paper-pattern gradient sync over the ranks (DESIGN.md §7): simulated
    on the model's device, or one a process when ``comm`` is a
    ``DistCommunicator`` over ``rules.batch``'s ranks.

    Metrics add ``bytes_per_rank`` (what each rank sent this step; every
    rank sends the same) and, on simulated ranks, ``rank_spread`` (the
    largest absolute difference between a rank's synced gradient and rank
    0's)."""
    if rules.fsdp:
        raise ValueError("the butterfly grad-sync path requires non-FSDP params")
    if compress not in (None, "int8"):
        raise ValueError(f"unknown compression {compress!r}")
    if api.model_axes(rules, mesh):
        return _butterfly_tp(cfg, mesh, rules, method=method, fanout=fanout,
                             microbatches=microbatches, clip_norm=clip_norm,
                             compress=compress, lr_kw=lr_kw, comm=comm)
    axes = tuple(rules.batch)
    batch_mesh = SimMesh(tuple(mesh.shape[a] for a in axes), axes)
    p = batch_mesh.ranks
    if comm is not None and comm.mesh != batch_mesh:
        raise ValueError(f"the communicator's mesh {comm.mesh} is not the batch axes' "
                         f"{batch_mesh}")
    loss_fn = api.train_loss_fn(cfg)
    opt = optim.get(cfg.optimizer)
    lr_kw = lr_kw or {}
    accum = DTYPES[cfg.grad_accum_dtype]

    def sync(g, c):
        if compress == "int8":
            return collectives.sync_leaf_int8(g, c, fanout=fanout, axes=axes)
        return collectives.sync_leaf(g, c, method=method, fanout=fanout, axes=axes)

    def step(model, opt_state, batch, step_idx):
        c = comm if comm is not None else collectives.Communicator(
            batch_mesh, next(model.parameters()).device)
        sent = int(c.bytes_sent[0])
        stacks = grad_buffers(model, microbatches, accum, lead=(len(c.ranks),))
        shards = _split_batch(batch, p)
        losses = []
        for i, r in enumerate(c.ranks):
            rank_out = shd.tree_map(lambda s: s[i], stacks)
            losses.append(_grads_of(loss_fn, model, shards[r], microbatches, accum,
                                    out=rank_out)[0])
            del rank_out
        loss = c.pmean(torch.stack(losses))  # lax.pmean
        grads: Dict = {}
        spread = torch.zeros((), dtype=torch.float32, device=c.device)
        for path, _ in list(sorted_leaves(stacks)):
            g = tree_get(stacks, path)
            tree_set(stacks, path, None)
            synced = sync(g, c)
            del g
            for i in range(1, len(c.ranks)):
                spread = torch.maximum(spread, (synced[i] - synced[0]).abs().max().float())
            tree_set(grads, path, synced[0].clone())
            del synced
        grads, gnorm = optim.clip_by_global_norm(grads, clip_norm)
        lr = optim.cosine_lr(step_idx, **lr_kw)
        model, opt_state = opt.apply(model, grads, opt_state, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "bytes_per_rank": int(c.bytes_sent[0]) - sent}
        if comm is None:
            metrics["rank_spread"] = spread
        return model, opt_state, metrics

    return step


def _butterfly_tp(cfg: ModelConfig, mesh: SimMesh, rules: MeshRules, *, method: str,
                  fanout: int, microbatches: int, clip_norm: float,
                  compress: Optional[str], lr_kw: Optional[Dict], comm):
    """The butterfly step with the model axis inside: each data group's
    backward runs tensor-parallel (its model ranks' blocks), then every
    rank's gradient of its block (and of each replicated leaf) is synced
    over ``rules.batch``'s axes within its model column. ``comm`` (a
    ``DistCommunicator`` of the whole mesh) or the model's simulated
    communicator carries both."""
    axes = tuple(rules.batch)
    opt = optim.get(cfg.optimizer)
    lr_kw = lr_kw or {}
    accum = DTYPES[cfg.grad_accum_dtype]
    n_groups = math.prod(mesh.shape[a] for a in axes)
    mod = encdec if cfg.family == "audio" else lm

    def sync(g, c):
        if compress == "int8":
            return collectives.sync_leaf_int8(g, c, fanout=fanout, axes=axes)
        return collectives.sync_leaf(g, c, method=method, fanout=fanout, axes=axes)

    def step(model, opt_state, batch, step_idx):
        api.check_sharding(model, rules, mesh)
        tp = model.tp
        c = tp.comm
        if comm is not None and comm is not c:
            raise ValueError("the model is sharded over another communicator")
        sent = int(c.bytes_sent[0])
        group = c.mesh.group_index(c.ranks, tp.rest)
        column = c.mesh.group_index(c.ranks, tp.axes)
        held = sorted(set(int(g) for g in group))
        shards = _split_batch(batch, n_groups)
        losses, grads_of = {}, {}
        for g in held:
            view = tp.for_group(g)
            losses[g], grads_of[g] = _grads_of(
                lambda m, b, v=view: mod.train_loss(cfg, m, b, tp=v), model,
                shards[g], microbatches, accum)
        loss = c.pmean(torch.stack([losses[int(g)] for g in group]))
        # each held rank's row: its data group's gradient of its block
        pos = {int(m): i for i, m in enumerate(tp.local)}
        first = np.array([np.flatnonzero((group == held[0]) & (column == m))[0]
                          for m in column])
        axis = optim.shard_axes(model)
        grads: Dict = {}
        spread = torch.zeros((), dtype=torch.float32, device=c.device)
        for path, ax in sorted(axis.items()):
            rows = []
            for g, m in zip(group, column):
                leaf = tree_get(grads_of[int(g)], path)
                rows.append(leaf if ax is None else leaf.select(ax, pos[int(m)]))
            synced = sync(torch.stack(rows), c)
            del rows
            for i in range(len(c.ranks)):
                spread = torch.maximum(
                    spread, (synced[i] - synced[first[i]]).abs().max().float())
            if ax is None:
                tree_set(grads, path, synced[0].clone())
            else:
                own = [synced[first[i]] for i in range(len(c.ranks)) if group[i] == held[0]]
                tree_set(grads, path, torch.stack(own, dim=ax))
            del synced
        del grads_of
        grads, gnorm = optim.clip_by_global_norm(grads, clip_norm, model)
        lr = optim.cosine_lr(step_idx, **lr_kw)
        model, opt_state = opt.apply(model, grads, opt_state, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "bytes_per_rank": int(c.bytes_sent[0]) - sent}
        if comm is None:
            metrics["rank_spread"] = spread
        return model, opt_state, metrics

    return step
