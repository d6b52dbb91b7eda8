"""Every dry-run cell under fake tensors (the port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh), the step of the shape's
kind runs once at the published size under ``FakeTensorMode``: shapes
and dtypes only, nothing allocated, on any host.  ``FlopCounterMode``
counts its matrix-product flops and ``MemTracker`` its peak memory
(:func:`repro_torch.launch.hlo_stats.measure`), in place of the
reference's ``jit(...).lower(...).compile()``; the cell's roofline terms
and one JSON a cell are written under ``experiments/dryrun_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch butterfly-bfs --mesh single

What each term of an LM row holds:

* flops: the global step's count over the chips (``flops_split:
  "ideal"``).  Never with ``prefill_corrections`` added: the port's
  prefill runs every query chunk, so the count sees them all.
* memory: the arguments a device holds, exact from the shard shapes of
  the production mesh (:func:`repro_torch.dist.sharding.tree_structs`),
  and the temporaries, the global step's fake peak less its arguments,
  over the chips (``memory_source: "fake, ideal split"``).
* collectives: what the port itself sends for the step on that mesh
  (``collectives_model: "port"``): on a mesh with a model axis, the
  tensor-parallel collectives of the step sharded over it
  (:func:`tp_step_stats`: the model built sharded on simulated ranks and
  the step run once under fake tensors, its ``TensorParallel`` record, which
  equals :func:`repro_torch.models.lm.tp_calls`), for every family, and
  with FSDP rules (an FSDP config's cells under ``xla``, on any mesh) its
  ``FullyShardedData`` record, equal to
  :func:`repro_torch.models.lm.fsdp_calls`; for a train step, also the
  gradient sync of each parameter leaf's model-axis shard that FSDP does
  not split over the data axes, run on fake tensors on a Communicator
  over them (its bytes equal
  :func:`repro_torch.core.collectives.grad_sync_bytes`).
* ``compile_s`` holds the seconds of the fake step, and
  ``compile_runtime_cfg_s`` those of the memory-only step of
  ``--no-analysis`` (the reference's compile-proof mode).

A BFS row holds one dense top-down level's terms
(:func:`bfs_level_terms`): the port's level loop reads the host every
level, so it cannot run under fake tensors.  A failing cell is recorded
with ``status: "fail"``, its error and trace, and counts in the exit code.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import platform
import time
import traceback
from typing import Dict, Optional

DEFAULT_OUT = "experiments/dryrun_torch"
# where a row was measured: fake tensors on this host, no device
HOST = f"host {platform.machine()} (no device)"

# the layout the BFS kernels run on (repro_torch.kernels.blocks.build_bfs_layout)
_EB, _SCATTER_WW = 512, 64


def input_specs(arch: str, shape_name: str, mesh, rules):
    """Allocation-free :class:`~repro_torch.dist.sharding.ShardStruct` of
    every model input of this (arch, shape) cell on ``mesh``."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import sharding as shd
    from repro_torch.models import api

    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    out = {"inputs": shd.tree_structs(api.input_defs(cfg, shape), cfg.compute_dtype,
                                      rules, mesh)}
    if shape.kind == "decode":
        out["cache"] = shd.tree_structs(api.cache_defs(cfg, shape), cfg.compute_dtype,
                                        rules, mesh)
    return out


def _parse_overrides(s: Optional[str]) -> Dict:
    """--override 'ring_local_cache=True,train_microbatches=8'"""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=")
        out[k.strip()] = ast.literal_eval(v.strip())
    return out


def _struct_bytes(tree) -> int:
    """Bytes of one device's shards of a ShardStruct tree."""
    from repro_torch.dist import sharding as shd

    return sum(math.prod(s.shard_shape) * s.dtype.itemsize
               for _, s in shd.tree_leaves_with_path(tree))


def _fake_inputs(defs, dtype):
    """Zero tensors of a PD tree (under the caller's fake mode)."""
    import torch

    from repro_torch.dist import sharding as shd

    return shd.tree_map(lambda pd: torch.zeros(pd.shape, dtype=shd.resolve_dtype(pd, dtype)),
                        defs)


def fake_step(cfg, shape, *, analysis: bool = True):
    """The global step of ``shape``'s kind at ``cfg``'s published size under
    ``FakeTensorMode``, measured: a
    :class:`~repro_torch.launch.hlo_stats.Measurement` (flops only with
    ``analysis``) and its seconds.

    train: the loss, its gradient and the configured optimizer's update
    (``train.step.build_train_step``, one microbatch: the flops of a step
    do not depend on the microbatching); prefill: ``api.prefill_fn``;
    decode: ``api.decode_fn`` at ``pos = seq_len - 1``, a host int (the
    port's decode builds its position from it)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_stats
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    t0 = time.perf_counter()
    with FakeTensorMode():
        model = api.build_model(cfg, torch.device("cpu"))
        ins = _fake_inputs(api.input_defs(cfg, shape), cfg.compute_dtype)
        if shape.kind == "train":
            state = optim.get(cfg.optimizer).init(model)
            fn = step_mod.build_train_step(cfg, microbatches=1)
            m = hlo_stats.measure(fn, model, state, ins, 0, flops=analysis)
        elif shape.kind == "prefill":
            m = hlo_stats.measure(api.prefill_fn(cfg), model, ins, flops=analysis)
        else:
            cache = _fake_inputs(api.cache_defs(cfg, shape), cfg.compute_dtype)
            m = hlo_stats.measure(api.decode_fn(cfg), model, cache, ins["token"],
                                  shape.seq_len - 1, flops=analysis)
    m.out = None  # the step's outputs are not kept
    return m, time.perf_counter() - t0


def tp_step_stats(cfg, shape, mesh, rules) -> Optional[Dict]:
    """The collectives one rank makes in the step of ``shape``'s kind at
    ``cfg`` on ``mesh``, sharded over ``rules.model`` and, with FSDP rules,
    over ``rules.fsdp``: the model built on simulated ranks and the step
    (the GSPMD train step, prefill, or decode at ``pos = seq_len - 1``) run
    once under ``FakeTensorMode``; the
    :class:`~repro_torch.core.collectives.TensorParallel` record plus the
    :class:`~repro_torch.core.collectives.FullyShardedData` record (its
    gathers and reduce-scatters, equal to ``lm.fsdp_calls``), in the shape
    of ``hlo_stats.collective_stats``. None where the mesh has no model
    axis and the rules no FSDP axes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_stats
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    if not api.model_axes(rules, mesh) and not api.fsdp_axes(rules, mesh):
        return None
    with FakeTensorMode():
        tp, fs = api.sharding_of(rules, mesh, torch.device("cpu"))
        model = api.build_model(cfg, torch.device("cpu"), tp, fs)
        ins = _fake_inputs(api.input_defs(cfg, shape), cfg.compute_dtype)
        if shape.kind == "train":
            state = optim.get(cfg.optimizer).init(model)
            step_mod.build_train_step(cfg, mesh=mesh, rules=rules)(model, state, ins, 0)
        elif shape.kind == "prefill":
            with torch.no_grad():
                api.prefill_fn(cfg, rules, mesh)(model, ins)
        else:
            cache = api.held_cache(model, _fake_inputs(api.cache_defs(cfg, shape),
                                                       cfg.compute_dtype))
            with torch.no_grad():
                api.decode_fn(cfg, rules, mesh)(model, cache, ins["token"], shape.seq_len - 1)
    stats = hlo_stats.total_stats([par.stats for par in (tp, fs) if par is not None])
    return {k: {"count": int(v["count"]), "operand_bytes": float(v["operand_bytes"]),
                "wire_bytes": float(v["wire_bytes"])} for k, v in stats.items()}


def _sync_stats(method: str, batch_mesh, fanout: int, n: int, dtype) -> Dict:
    """The Communicator's record of one leaf's gradient sync: ``n`` elements
    of ``dtype`` a rank over ``batch_mesh``'s axes, on fake tensors; its
    bytes a rank must equal ``grad_sync_bytes``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import collectives
    from repro_torch.launch import hlo_stats

    axes = batch_mesh.axis_names
    comm = collectives.Communicator(batch_mesh, "cpu")
    with FakeTensorMode():
        g = torch.zeros((batch_mesh.ranks, n), dtype=dtype)
        collectives.sync_leaf(g, comm, method=method, fanout=fanout, axes=axes)
    want = collectives.grad_sync_bytes(method, batch_mesh.sizes, fanout, n, dtype.itemsize)
    if int(comm.bytes_sent[0]) != want:
        raise AssertionError(f"{method} sync of {n} elements sent {comm.bytes_sent[0]} "
                             f"bytes a rank, the byte model {want}")
    return hlo_stats.collective_stats(comm)


def grad_sync_stats(cfg, mesh, rules, grad_sync: str, fanout: int) -> Dict:
    """Per collective kind, what a rank sends to sync a train step's
    gradient on ``mesh``: each parameter leaf's model-axis shard synced
    over the data axes (``rules.batch``) by ``grad_sync`` (``xla`` is
    ``xla_psum``), summed over the leaves. A leaf FSDP rules split over
    the data axes has none: the step's reduce-scatter syncs it
    (:func:`tp_step_stats` counts that)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.sharding import SimMesh
    from repro_torch.launch import hlo_stats
    from repro_torch.models import api

    method = "xla_psum" if grad_sync == "xla" else grad_sync
    axes = tuple(rules.batch)
    batch_mesh = SimMesh(tuple(mesh.shape[a] for a in axes), axes)
    memo: Dict = {}
    parts = []
    for _, pd in shd.tree_leaves_with_path(api.param_defs(cfg)):
        if shd.held_block(pd, rules, mesh)[1] is not None:
            continue
        spec = shd.spec_for(pd, rules, mesh)
        split = math.prod(mesh.shape[a] for entry in spec if entry is not None
                          for a in ((entry,) if isinstance(entry, str) else entry)
                          if a in rules.model)
        n = math.prod(pd.shape) // split
        dtype = shd.resolve_dtype(pd, cfg.param_dtype)
        key = (n, dtype)
        if key not in memo:
            memo[key] = _sync_stats(method, batch_mesh, fanout, n, dtype)
        parts.append(memo[key])
    return hlo_stats.total_stats(parts)


def _ratios(rec: Dict, chips: int, mf: float) -> None:
    """The reference's derived fields of an LM row, from its flops, bytes
    and wire bytes (``src/repro/launch/dryrun.py``'s formulas)."""
    from repro_torch.launch import hlo_stats

    roof = hlo_stats.roofline(rec["flops_per_device"], rec["bytes_per_device"],
                              rec["collective_wire_bytes"], rec["collective_operand_bytes"])
    flops_global = rec["flops_per_device"] * chips
    rec.update(
        t_compute=roof.t_compute, t_memory=roof.t_memory, t_collective=roof.t_collective,
        dominant=roof.dominant, step_time_est=roof.step_time, model_flops=mf,
        useful_flops_ratio=(mf / flops_global) if flops_global else 0.0,
        roofline_fraction=((mf / chips / hlo_stats.PEAK_FLOPS) / roof.step_time
                           if roof.step_time > 0 else 0.0),
    )


def derive(rec: Dict, tables: Dict) -> Dict:
    """Every derived field of an LM row from its saved tables (flops by op,
    collectives by kind, memory parts) with the current code: flops,
    bytes, collectives, terms, ``dominant``, ratios.  Used by the dry run
    and by :mod:`.reroof`."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import analytic, hlo_stats
    from repro_torch.models import api

    cfg = dataclasses.replace(configs.get_config(rec["arch"]), **rec.get("overrides", {}))
    shape = SHAPES[rec["shape"]]
    chips = rec["chips"]
    flops_global = float(sum(tables["flops_by_op"].values()))
    cstats = tables["collectives"]
    mem = tables["memory"]
    counts = api.param_counts(cfg)
    args_dev = mem["arguments_per_device"]
    rec.update(
        memory=hlo_stats.memory_dict(args_dev, mem["outputs_global"] / chips,
                                     args_dev + mem["temporaries_global"] / chips,
                                     mem["source"]),
        memory_source=mem["source"] + ", ideal split",
        flops_per_device=flops_global / chips,
        flops_per_device_raw=flops_global / chips,
        flops_split="ideal",
        bytes_per_device=analytic.step_bytes(cfg, shape)["global"] / chips,
        collective_operand_bytes=sum(v["operand_bytes"] for v in cstats.values()),
        collective_wire_bytes=sum(v["wire_bytes"] for v in cstats.values()),
        collectives=cstats,
        collectives_runtime=cstats,
        params_total=counts["total"],
        params_active=counts["active"],
    )
    rec["bytes_per_device_raw"] = rec["bytes_per_device"]
    _ratios(rec, chips, api.model_flops(cfg, shape))
    return rec


def run_lm_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: str,
    *,
    grad_sync: str = "xla",
    fanout: int = 2,
    overrides: Optional[Dict] = None,
    tag_suffix: str = "",
    analysis: bool = True,
    verbose: bool = True,
    mesh=None,
    steps: Optional[Dict] = None,
) -> Dict:
    """One LM cell on the production mesh (``mesh`` replaces it, e.g. a
    small ``SimMesh`` in a test); writes ``<out_dir>/<mesh>/<tag>.json``
    and, with ``analysis``, its tables under ``tables/``.  The global
    step's measurement is the same on every mesh: ``steps`` (a dict the
    caller keeps) holds it for the cells of the same arch, shape,
    overrides and mode."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES, shape_supported
    from repro_torch.core import collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.sharding import rules_for_mesh
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api
    from repro_torch.train import optim

    cfg = dataclasses.replace(configs.get_config(arch), scan_unroll=True, **(overrides or {}))
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}" + (f"__{tag_suffix}" if tag_suffix else "")
    ok, reason = shape_supported(cfg, shape)
    rec = dict(
        arch=arch, shape=shape_name, mesh=mesh_name, kind=shape.kind,
        grad_sync=grad_sync, overrides=overrides or {}, tag=tag_suffix,
        status="skip" if not ok else "pending", source="fake",
        device=HOST,
    )
    if not ok:
        rec["skip_reason"] = reason
        _write(out_dir, mesh_name, tag, rec)
        if verbose:
            print(f"[{mesh_name}] {tag}: SKIP ({reason.split(':')[0]})")
        return rec

    try:
        mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
        chips = mesh.ranks
        rules = rules_for_mesh(mesh, cfg.fsdp and grad_sync == "xla")
        pdefs = api.param_defs(cfg)
        arg_dev = _struct_bytes(shd.tree_structs(pdefs, cfg.param_dtype, rules, mesh))
        arg_dev += _struct_bytes(shd.tree_structs(api.input_defs(cfg, shape),
                                                  cfg.compute_dtype, rules, mesh))
        if shape.kind == "train":
            arg_dev += _struct_bytes(shd.tree_structs(
                optim.get(cfg.optimizer).state_defs(pdefs), "float32", rules, mesh))
        elif shape.kind == "decode":
            arg_dev += _struct_bytes(shd.tree_structs(api.cache_defs(cfg, shape),
                                                      cfg.compute_dtype, rules, mesh))
        steps = {} if steps is None else steps
        key = (arch, shape_name, tuple(sorted((overrides or {}).items())), analysis)
        if key not in steps:
            steps[key] = fake_step(cfg, shape, analysis=analysis)
        m, t_step = steps[key]
        mem = dict(arguments_per_device=float(arg_dev),
                   temporaries_global=m.memory["temp_size_in_bytes"],
                   outputs_global=m.memory["output_size_in_bytes"],
                   arguments_global=m.memory["argument_size_in_bytes"],
                   source=m.memory["source"])
        if not analysis:
            # memory only, as the reference's compile-proof mode
            rec.update(status="ok", chips=chips, analysis=False,
                       compile_runtime_cfg_s=round(t_step, 1),
                       memory=hlo_stats.memory_dict(
                           arg_dev, mem["outputs_global"] / chips,
                           arg_dev + mem["temporaries_global"] / chips, "fake"),
                       memory_source="fake, ideal split")
            if verbose:
                print(f"[{mesh_name}] {tag}: OK (memory only) {t_step:.0f}s "
                      f"mem/dev={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB")
            _write(out_dir, mesh_name, tag, rec)
            return rec

        parts = []
        if shape.kind == "train":
            parts.append(grad_sync_stats(cfg, mesh, rules, grad_sync, fanout))
        tp = tp_step_stats(cfg, shape, mesh, rules)
        if tp is not None:
            parts.append(tp)
        cstats = hlo_stats.total_stats(parts) if parts else collectives.empty_stats()
        tables = dict(flops_by_op=m.flops_by_op, collectives=cstats, memory=mem)
        _save_tables(out_dir, mesh_name, tag, tables)
        rec.update(status="ok", chips=chips, compile_s=round(t_step, 1),
                   compile_runtime_cfg_s=0.0, collectives_model="port",
                   runtime_microbatches=cfg.train_microbatches if shape.kind == "train" else 1,
                   flops_by_op=m.flops_by_op)
        derive(rec, tables)
        if verbose:
            print(f"[{mesh_name}] {tag}: OK fake step {t_step:.1f}s "
                  f"mem/dev={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB "
                  f"dom={rec['dominant']} "
                  f"t=({rec['t_compute'] * 1e3:.1f},{rec['t_memory'] * 1e3:.1f},"
                  f"{rec['t_collective'] * 1e3:.1f})ms "
                  f"MF/flops={rec['useful_flops_ratio']:.2f} "
                  f"roofline={rec['roofline_fraction'] * 100:.1f}%")
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{mesh_name}] {tag}: FAIL {type(e).__name__}: {str(e)[:300]}")
    _write(out_dir, mesh_name, tag, rec)
    return rec


def bfs_level_terms(shapes, cfg, mesh) -> Dict:
    """One dense top-down BFS level's terms at ``shapes`` (a
    ``SyntheticShapes`` or a ``PartitionedGraph``: ``p``, ``n_words``,
    ``emax``) on ``mesh`` under ``cfg``'s sync (the dense branch of the
    sparse and adaptive ones).

    * collectives: the level's sync run on fake tensors on a Communicator
      over ``mesh`` (its record by kind, and the bytes and sends a rank,
      which must equal the byte model ``core/flightrec.py`` uses over the
      axes' sizes); its merges' least bytes tallied as the kernels do.
    * least bytes of the level's kernel launches (all ranks): the gather,
      the scatter (on ``kernels.blocks``' layout: blocks of 512 slots,
      scatter windows of 64 words, at least one block a window) and the
      sync's merges, by the formulas of ``kernels/bounds.py``; where one
      reads values (the distinct words a gather reads, the scatter's
      sectors with an active slot) its upper bound: every word up to one
      per edge slot, every sector up to one per edge.
    """
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import bfs as bfs_mod
    from repro_torch.core import collectives, flightrec
    from repro_torch.kernels import bounds
    from repro_torch.launch import hlo_stats

    p, n_words, emax = int(shapes.p), int(shapes.n_words), int(shapes.emax)
    dense = cfg if cfg.sync not in ("sparse", "adaptive") else dataclasses.replace(
        cfg, sync="butterfly")
    comm = collectives.Communicator(mesh, "cpu")
    with FakeTensorMode(), bounds.tallying() as counts:
        words = torch.zeros((p, n_words), dtype=torch.int32)
        mem = hlo_stats.measure(bfs_mod._sync_frontier, words, dense, comm,
                                use_kernels=True, flops=False).memory
    trace = flightrec.TraversalTrace(
        algo="bfs", sync=dense.sync, p=p, fanout=cfg.fanout, n_words=n_words,
        capacity=cfg.resolved_capacity(n_words), density_threshold=cfg.density_threshold,
        data=_dense_row(), axis_sizes=flightrec.axis_sizes(cfg, mesh))
    model_bytes = float(trace.level_bytes_per_node()[0])
    if int(comm.bytes_sent[0]) != model_bytes:
        raise AssertionError(f"a dense {dense.sync} level sent {comm.bytes_sent[0]} bytes "
                             f"a rank, the byte model {model_bytes}")
    e_g = -(-emax // _EB) * _EB  # the gather's slots
    n_windows = -(-n_words // _SCATTER_WW)
    nb_s = -(-emax // _EB) + n_windows  # every window owns a block
    gather = 4 * min(n_words, e_g) + 4 * e_g + 4 * (e_g // _EB) + e_g
    scatter = (nb_s * _EB + 4 * nb_s + 4 * n_windows * _SCATTER_WW
               + bounds.SECTOR_BYTES * min(emax, nb_s * _EB * 4 // bounds.SECTOR_BYTES))
    merge = bounds.total_bytes(counts)
    return dict(
        bytes_sent=int(comm.bytes_sent[0]), sends=int(comm.sends[0]),
        collectives=hlo_stats.collective_stats(comm),
        least_bytes={"gather": float(p * gather), "scatter": float(p * scatter),
                     "merge": float(merge)},
        least_bytes_total=float(p * (gather + scatter) + merge),
        sync_temporaries=mem["temp_size_in_bytes"],
        upper_bounds=["gather: distinct words <= min(n_words, edge slots)",
                      "scatter: active sectors <= min(edges, sectors)"],
    )


def _dense_row():
    import numpy as np

    from repro_torch.core import flightrec

    row = np.zeros((1, flightrec.TRACE_COLS), dtype=np.int32)
    row[0, flightrec.COL_LEVEL] = 1
    row[0, flightrec.COL_BRANCH] = 0  # dense
    return row


def run_bfs_cell(
    multi_pod: bool,
    out_dir: str,
    *,
    scale: int = 29,
    edge_factor: int = 8,
    fanout: int = 4,
    sync: str = "butterfly",
    verbose: bool = True,
    mesh=None,
) -> Dict:
    """The paper's own workload on the production mesh (``mesh`` replaces
    it): distributed BFS with butterfly frontier synchronization over all
    mesh axes, one dense top-down level's terms at the synthetic shapes of
    a Kronecker graph of ``scale``."""
    from repro_torch.core import bfs
    from repro_torch.graph.partition import synthetic_shapes
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = "multi" if multi_pod else "single"
    tag = f"butterfly-bfs__kron{scale}_ef{edge_factor}_f{fanout}_{sync}"
    rec = dict(
        arch="butterfly-bfs", shape=f"kron{scale}_ef{edge_factor}",
        mesh=mesh_name, kind="bfs", sync=sync, fanout=fanout, status="pending",
        source="fake", device=HOST,
    )
    try:
        mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
        axes = tuple(mesh.axis_names)
        chips = mesh.ranks
        shapes = synthetic_shapes(1 << scale, 2 * (1 << scale) * edge_factor, chips)
        cfg = bfs.BFSConfig(axes=axes, fanout=fanout, sync=sync,
                            mode="top_down", max_levels=64)
        t0 = time.perf_counter()
        terms = bfs_level_terms(shapes, cfg, mesh)
        t_level = time.perf_counter() - t0
        args_dev = sum(4 * math.prod(s[1:]) for s in shapes.array_shapes().values())
        bytes_dev = terms["least_bytes_total"] / chips
        roof = hlo_stats.roofline(0.0, bytes_dev, terms["bytes_sent"])
        rec.update(
            status="ok", chips=chips,
            n_vertices=shapes.n, n_edges=shapes.n_edges,
            compile_s=round(t_level, 1),
            memory=hlo_stats.memory_dict(
                args_dev, 0, args_dev + terms["sync_temporaries"] / chips, "fake"),
            memory_source="arguments from array_shapes(), temporaries the fake peak of "
                          "the level's sync, ideal split",
            flops_per_device=0.0, bytes_per_device=bytes_dev,
            collective_operand_bytes=roof.collective_operand_bytes,
            collective_wire_bytes=roof.collective_wire_bytes,
            collectives=terms["collectives"], sends_per_level=terms["sends"],
            least_bytes=terms["least_bytes"], least_bytes_upper_bounds=terms["upper_bounds"],
            t_compute=roof.t_compute, t_memory=roof.t_memory,
            t_collective=roof.t_collective, dominant=roof.dominant,
        )
        if verbose:
            print(f"[{mesh_name}] {tag}: OK {t_level:.1f}s "
                  f"mem/dev={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB "
                  f"dom={roof.dominant} sends/level={terms['sends']}")
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{mesh_name}] {tag}: FAIL {type(e).__name__}: {str(e)[:300]}")
    _write(out_dir, mesh_name, tag, rec)
    return rec


def _write(out_dir: str, mesh_name: str, tag: str, rec: Dict) -> None:
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def _save_tables(out_dir: str, mesh_name: str, tag: str, tables: Dict) -> None:
    """Persist what the row's terms are derived from (flops by op,
    collectives by kind, memory parts), so :mod:`.reroof` re-derives the
    row without measuring again."""
    d = os.path.join(out_dir, mesh_name, "tables")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{tag}.json"), "w") as f:
        json.dump(tables, f, indent=1, default=float)


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id | all | butterfly-bfs (comma-separated ok)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--grad-sync", default="xla",
                    choices=["xla", "butterfly", "rabenseifner", "all_to_all"])
    ap.add_argument("--fanout", type=int, default=2)
    ap.add_argument("--bfs-scale", type=int, default=29)
    ap.add_argument("--bfs-ef", type=int, default=8)
    ap.add_argument("--bfs-sync", default="butterfly")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", default=None,
                    help="ModelConfig overrides, e.g. 'ring_local_cache=True'")
    ap.add_argument("--tag", default="",
                    help="suffix for the output file (perf variants)")
    ap.add_argument("--no-analysis", action="store_true",
                    help="memory only (no flop count, no collectives), as the "
                         "reference's compile-proof mode")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = configs.ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    t0 = time.perf_counter()
    n_fail = 0
    steps: Dict = {}
    for mp in meshes:
        mesh_name = "multi" if mp else "single"
        for arch in archs:
            if arch == "butterfly-bfs":
                rec = run_bfs_cell(mp, args.out, scale=args.bfs_scale,
                                   edge_factor=args.bfs_ef, fanout=args.fanout,
                                   sync=args.bfs_sync)
                n_fail += rec["status"] == "fail"
                continue
            for shp in shapes:
                fname = f"{arch}__{shp}" + (f"__{args.tag}" if args.tag else "")
                tagfile = os.path.join(args.out, mesh_name, f"{fname}.json")
                if args.skip_existing and os.path.exists(tagfile):
                    try:
                        with open(tagfile) as f:
                            st = json.load(f).get("status")
                    except (OSError, ValueError):
                        st = None
                    if st in ("ok", "skip"):
                        print(f"[{mesh_name}] {arch}__{shp}: cached ({st})")
                        continue
                rec = run_lm_cell(arch, shp, mp, args.out, grad_sync=args.grad_sync,
                                  fanout=args.fanout, overrides=overrides,
                                  tag_suffix=args.tag, analysis=not args.no_analysis,
                                  steps=steps)
                n_fail += rec["status"] == "fail"
    print(f"dry-run done in {time.perf_counter() - t0:.0f} s; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
