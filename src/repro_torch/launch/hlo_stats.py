"""Roofline terms, measured (the port of ``repro.launch.hlo_stats``).

The reference reads its roofline terms off a compiled XLA program: dot
flops and collective bytes parsed from the optimized HLO, memory from
``memory_analysis()``.  The port compiles nothing, so it has no HLO and
this module parses none.  Each reference function has a counterpart that
measures the same quantity on the running program:

* ``dot_flops(hlo)`` -> :func:`count_flops`: ``FlopCounterMode`` around a
  call.  Its registry counts matrix products (and convolutions and fused
  attention, which the port never calls: its convolutions are shifted
  adds, its attention two einsums), as ``dot_flops`` counts ``dot``s.  It
  runs on fake tensors (``FakeTensorMode``: shapes only, nothing
  allocated) as on real ones.
* ``collective_stats(hlo)`` -> :func:`collective_stats` of a
  :class:`~repro_torch.core.collectives.Communicator`: the calls it
  recorded by the reference's five kinds (``Communicator.collectives``).
* ``conditional_branch_stats(hlo)`` -> :func:`branch_stats`: each branch
  of an adaptive sync run on a fresh Communicator, forced by its input.
  ``computation_collective_stats`` and ``_segment_computations`` walk HLO
  computations for that function only and have no counterpart.
* ``roofline_from(compiled)`` -> :func:`roofline`, which fills the same
  :class:`Roofline` from a flop count, a byte count and wire bytes.
* ``memory_stats(compiled)`` -> :func:`memory_stats`: the reference's keys
  from a measured peak, with its ``source``: ``fake`` (``MemTracker`` under
  fake tensors), ``cpu`` (``MemTracker`` on real tensors) or ``cuda``
  (``torch.cuda.max_memory_allocated``).

The constants are the H100 SXM5's (NVIDIA H100 Tensor Core GPU data
sheet, SXM column); this module holds no other hardware's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.bfs import resolve_device
from repro_torch.core.collectives import COLLECTIVE_KINDS, Communicator, empty_stats

#: Dense bfloat16 tensor-core peak, 989 TFLOP/s.
PEAK_FLOPS = 989e12
#: HBM3 memory rate, 3.35 TB/s.
HBM_BW = 3.35e12
#: NVLink 4 rate a direction: 900 GB/s total bidirectional, 450 GB/s each way.
LINK_BW = 450e9

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLLECTIVE_KINDS", "Measurement",
           "measure", "count_flops", "memory_stats", "collective_stats", "branch_stats",
           "forcing_inputs", "total_stats", "Roofline", "roofline", "tensors_of", "nbytes",
           "memory_dict"]


# ---------------------------------------------------------------------------
# Flops and memory of one call
# ---------------------------------------------------------------------------


def tensors_of(obj) -> List[torch.Tensor]:
    """Every tensor of ``obj``: a tensor, a module's parameters and buffers,
    or the leaves of nested dicts, lists and tuples; others are skipped."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors_of(o)]
    return []


def _storages(tensors) -> Dict[int, int]:
    """storage key -> its bytes, each storage once (views share one)."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def nbytes(obj) -> int:
    """The bytes of ``obj``'s tensors, each storage counted once."""
    return sum(_storages(tensors_of(obj)).values())


def _source(tensors) -> str:
    from torch._subclasses.fake_tensor import FakeTensor

    if any(isinstance(t, FakeTensor) for t in tensors):
        return "fake"
    return "cuda" if any(t.is_cuda for t in tensors) else "cpu"


def _tracker():
    """A ``MemTracker`` that hooks the gradients of parameters that take one
    only: its own hook installation refuses a module with a frozen
    parameter, as a serving step's are."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def _track_module_params_and_buffers(self, module, install_grad_hooks=True):
            hooks = install_grad_hooks and all(p.requires_grad for p in module.parameters())
            return super()._track_module_params_and_buffers(module, hooks)

    return Tracker()


@dataclasses.dataclass
class Measurement:
    """What :func:`measure` read from one call: its output, its matrix-product
    flops (total and by op) and its memory (:func:`memory_stats`'s keys)."""

    out: Any
    flops: float
    flops_by_op: Dict[str, float]
    memory: Optional[Dict[str, float]]


def memory_dict(args_b: int, out_b: int, peak: int, source: str) -> Dict[str, float]:
    """The reference's keys from a measured peak.  The peak holds the
    arguments, the temporaries and the outputs (allocated inside the
    call), so the outputs count as aliased: the reference's formula
    (arguments + outputs + temporaries - aliases) gives the measured peak."""
    out = {"argument_size_in_bytes": float(args_b),
           "output_size_in_bytes": float(out_b),
           "temp_size_in_bytes": float(max(peak - args_b, 0)),
           "alias_size_in_bytes": float(out_b),
           "generated_code_size_in_bytes": 0.0}
    out["peak_bytes_per_device"] = (out["argument_size_in_bytes"]
                                    + out["output_size_in_bytes"]
                                    + out["temp_size_in_bytes"]
                                    - out["alias_size_in_bytes"])
    out["source"] = source
    return out


def measure(fn: Callable, *args, flops: bool = True, memory: bool = True,
            **kwargs) -> Measurement:
    """``fn(*args, **kwargs)`` once, its flops counted by ``FlopCounterMode``
    and its peak memory tracked, in one pass.

    The arguments' bytes are exact (each storage of the arguments' tensors
    once); the peak is ``MemTracker``'s (the arguments tracked as external
    tensors) on fake or CPU tensors, and on the card the peak of
    ``torch.cuda.max_memory_allocated`` over the call less what was
    allocated before it, plus the arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_t = tensors_of(list(args) + list(kwargs.values()))
    arg_st = _storages(arg_t)
    args_b = sum(arg_st.values())
    source = _source(arg_t)
    fc = FlopCounterMode(display=False) if flops else contextlib.nullcontext()
    tracker = None
    if memory and source != "cuda":
        tracker = _tracker()
        seen = set()
        for t in arg_t:  # each storage once, as the arguments' bytes count it
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                tracker.track_external(t)
    elif memory:
        dev = next(t.device for t in arg_t if t.is_cuda)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    with tracker if tracker is not None else contextlib.nullcontext():
        with fc:
            out = fn(*args, **kwargs)
    mem = None
    if memory:
        if tracker is not None:
            peak = max(s["Total"] for s in tracker.get_tracker_snapshot("peak").values())
        else:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base + args_b
        out_st = _storages(tensors_of(out))
        out_b = sum(b for k, b in out_st.items() if k not in arg_st)
        mem = memory_dict(args_b, out_b, peak, source)
    if flops:
        by_op = {str(op): float(n) for op, n in fc.get_flop_counts().get("Global", {}).items()}
        total = float(fc.get_total_flops())
    else:
        by_op, total = {}, 0.0
    return Measurement(out, total, by_op, mem)


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[Any, float, Dict[str, float]]:
    """``(output, total flops, flops by op)`` of ``fn(*args, **kwargs)``:
    the counterpart of ``dot_flops``, matrix products only."""
    m = measure(fn, *args, memory=False, **kwargs)
    return m.out, m.flops, m.flops_by_op


def memory_stats(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """The reference's ``memory_stats`` keys for ``fn(*args, **kwargs)``,
    plus ``source`` (``fake``, ``cpu`` or ``cuda``): arguments exact,
    temporaries the measured peak less the arguments."""
    return measure(fn, *args, flops=False, **kwargs).memory


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def collective_stats(comm: Communicator) -> Dict[str, Dict[str, float]]:
    """Per collective kind, in the reference's shape: ``count``,
    ``operand_bytes`` (one rank's buffer a call) and ``wire_bytes`` (what a
    rank sent), as ``comm`` recorded them."""
    return {k: {"count": int(v["count"]), "operand_bytes": float(v["operand_bytes"]),
                "wire_bytes": float(v["wire_bytes"])}
            for k, v in comm.collectives.items()}


def forcing_inputs(p: int, n_words: int, device="cuda") -> List[Tuple[str, torch.Tensor]]:
    """Bitmaps that force each branch of an adaptive OR sync, in the
    reference's branch order: every bit set on every rank forces the dense
    branch (its ``lax.cond`` False path, branch 0), an empty bitmap the
    sparse one (branch 1). On ``device``: the card by default (raises when
    there is none)."""
    device = resolve_device(device)
    return [("dense", torch.full((p, n_words), -1, dtype=torch.int32, device=device)),
            ("sparse", torch.zeros((p, n_words), dtype=torch.int32, device=device))]


def branch_stats(fn: Callable, inputs: Sequence[Tuple[str, torch.Tensor]],
                 mesh) -> List[List[Tuple[str, Dict[str, Dict[str, float]]]]]:
    """The collectives of each branch of one adaptive sync, in the shape of
    the reference's ``conditional_branch_stats``: one conditional, a list
    of ``(branch name, stats)`` in branch order.  ``fn(x, comm)`` runs once
    for each ``(name, x)`` of ``inputs`` (each forcing its branch, e.g.
    :func:`forcing_inputs`) on a fresh Communicator over ``mesh`` (a rank
    count or a ``SimMesh``) on ``x``'s device."""
    out = []
    for name, x in inputs:
        comm = Communicator(mesh, x.device)
        fn(x, comm)
        out.append((name, collective_stats(comm)))
    return [out]


def total_stats(stats: Sequence[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """The kind-by-kind sum of several stats."""
    out = empty_stats()
    for st in stats:
        for k, v in st.items():
            for f in ("count", "operand_bytes", "wire_bytes"):
                out[k][f] += v[f]
    return out


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_operand_bytes: float
    collective_wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: the largest of the three terms (tensor
        cores, HBM and the links can overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict:
        """The fields, then ``dominant`` and ``step_time``."""
        out = dataclasses.asdict(self)
        out.update(dominant=self.dominant, step_time=self.step_time)
        return out


def roofline(flops: float, bytes_: float, wire_bytes: float,
             operand_bytes: Optional[float] = None) -> Roofline:
    """The H100 roofline of ``flops`` and ``bytes_`` a device and
    ``wire_bytes`` it sends (``operand_bytes`` its collectives' operands,
    the wire bytes when not given)."""
    return Roofline(
        flops_per_device=float(flops),
        bytes_per_device=float(bytes_),
        collective_operand_bytes=float(wire_bytes if operand_bytes is None
                                       else operand_bytes),
        collective_wire_bytes=float(wire_bytes),
        t_compute=flops / PEAK_FLOPS,
        t_memory=bytes_ / HBM_BW,
        t_collective=wire_bytes / LINK_BW,
    )
