"""Vertex programs on the butterfly exchange.

The port of ``repro.programs``: one gather-apply-scatter core
(:mod:`repro_torch.programs.core`) serving four graph-analytics programs,
each a :class:`VertexProgram` run on the same round loop and the same
syncs as every traversal:

* ``pagerank`` — power iteration; ADD_F32 **delta** sparse mode (the first
  non-idempotent monoid on the sparse path);
* ``cc``       — min-label-propagation connected components; MIN_U32
  remerge mode, bit-exact vs union-find;
* ``tri``      — triangle counting; one OR exchange replicates neighbor
  bitmaps, wedge checks finish locally;
* ``kcore``    — iterative peeling via degree-threshold OR scatter waves.
"""

from __future__ import annotations

from repro_torch.programs.cc import ConnectedComponentsProgram, cc_reference
from repro_torch.programs.core import (
    SYNCS,
    ProgramConfig,
    ProgramContext,
    VertexProgram,
    build_program_fn,
    program_msg_words,
    program_rows,
    run_program,
)
from repro_torch.programs.kcore import KCoreProgram, kcore_reference
from repro_torch.programs.pagerank import (
    PageRankProgram,
    pagerank_reference,
    rank_arg,
    repair_rank_rows,
    uniform_ranks,
)
from repro_torch.programs.triangles import (
    TriangleCountProgram,
    total_triangles,
    triangles_reference,
)

#: The algo registry: name -> shared program instance (programs are
#: stateless — all run state lives in the loop carry).
PROGRAMS = {
    p.name: p
    for p in (
        PageRankProgram(),
        ConnectedComponentsProgram(),
        TriangleCountProgram(),
        KCoreProgram(),
    )
}

PROGRAM_ALGOS = tuple(PROGRAMS)


def by_name(name: str) -> VertexProgram:
    try:
        return PROGRAMS[name]
    except KeyError:
        raise ValueError(
            f"unknown vertex program {name!r}; expected one of {sorted(PROGRAMS)}"
        ) from None


__all__ = [
    "SYNCS",
    "PROGRAMS",
    "PROGRAM_ALGOS",
    "ProgramConfig",
    "ProgramContext",
    "VertexProgram",
    "build_program_fn",
    "by_name",
    "program_msg_words",
    "program_rows",
    "run_program",
    "PageRankProgram",
    "ConnectedComponentsProgram",
    "TriangleCountProgram",
    "KCoreProgram",
    "pagerank_reference",
    "cc_reference",
    "triangles_reference",
    "kcore_reference",
    "total_triangles",
    "uniform_ranks",
    "rank_arg",
    "repair_rank_rows",
]
