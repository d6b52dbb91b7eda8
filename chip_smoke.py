#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py    # weighted Kronecker scale 23, EF 8, P=16; torus 1024^2

Drives the port's main path, single-source ButterFly BFS, through the entry
points a user calls (``build_bfs_fn`` on ``place_arrays``), then each
further path of the port (the sparse, adaptive, Rabenseifner and xla
frontier syncs, the flight recorder, the multi-source BFS wave, SSSP,
Brandes betweenness and the vertex programs PageRank, connected
components, k-core and triangle counting, streaming mutations, the query
engine, the query service, the replicated serving CLI and the cost-model
profiler, and the LM side's serving and training paths), and holds them to
account:

1. card: name and power limit (nvidia-smi), torch, CUDA and numpy versions;
2. build: the four CUDA kernels, compiled from ``src/repro_torch/kernels/csrc``;
3. the LM serving path, before the graph phases (its state freed after):
   qwen3-1.7b at its published size (28 layers, d 2048, 1,720,837,120
   parameters) in bfloat16 with seeded weights, ``serve.engine.generate``
   of 8 prompts of 512 tokens, 64 greedy new tokens, twice (identical, ids
   in the vocabulary, the first token the forward's argmax), the same loop
   timed step by step against the decode step's least time over HBM, a
   sampled run (temperature 0.8, top-k 50) twice (repeatable); in float32
   with TF32 off, prefill + teacher-forced decode against the full forward
   at the reference's tolerance (qwen3-1.7b: 3072 + 64 tokens, mamba2-130m
   at its published size: 1024 + 32); every arch's reduced config on the
   card against the port on the CPU (same weights, 1e-4); none of the four
   graph kernels launched;
3b. the LM training path, after phase 3 (its state freed after): (a)
   qwen3-1.7b at its published size trained 4 steps by
   ``train.loop.train`` (bfloat16, remat, AdamW, 16 x 1024 tokens in the
   config's 4 microbatches): every loss finite, the last below the first;
   step time, tokens a second, model FLOPs against the bfloat16 peak, peak
   memory; (b) its gradient synced over 4 simulated ranks (4 rows each, one
   a microbatch) by ``xla_psum``, the butterfly at fanout 2 and 4,
   Rabenseifner and all-to-all, each within 1e-5 (relative to each leaf's
   largest) of the one-device gradient of the same 16 rows, the ranks'
   copies bit-identical at fanout 2, each rank's bytes equal to the byte
   model; the int8 wire within ``depth max|g| / 127`` at about a quarter of
   the bytes; one full butterfly step with AdamW; (c) its widths cut to 2
   layers: 6 steps uninterrupted equal bit for bit to a run failed at step
   4 and restarted from its step-3 checkpoint (deterministic algorithms),
   an async save's blocking copy against its write; (d) every arch's
   reduced config, 2 train steps on the card against the port on the CPU
   (float32, TF32 off, 1e-5), and ``launch.train --smoke`` on the card;
   none of the four graph kernels launched;
3c. the LM side's multi-device half, after phase 3b (its state freed
   after): (a) qwen3-1.7b's parameter, optimizer-state and input specs at
   its published size on both production meshes (descriptors: the split
   share of the bytes, a device's bytes), its seeded parameters placed on
   a (data 2, model 4) mesh on the card, every shard its block and the
   gathered tree equal bit for bit; (b) phase 3b(c)'s 2-layer checkpoint
   restored by ``ckpt.restore(mesh=, pspecs=)`` onto (data 2, model 4) and
   data 8 with fsdp, every shard its block of the saved array bit for bit,
   seconds and peak memory; (c) GPipe of ``tanh(x @ W)`` at qwen3-1.7b's
   depth and width (``[28, 2048, 2048]`` float32, TF32 off) in 4 stages, 8
   microbatches of (1024, 2048): forward and weight gradient against the
   sequential stack at the reference test's tolerances, 11 handoff ticks of
   8 MiB from each stage but the last, pipelined against sequential time;
   (d) 4 gloo processes on the card (pinned host staging), each with 4 of
   the 16 rows of phase 3b's batch on the 2-layer cut: every sync method
   equal to the simulated ``Communicator`` on the same per-rank gradients
   (bit for bit by checksums, else within 1e-5), bytes equal to the model,
   seconds with the staging's share, one butterfly step a process equal
   to the simulated-rank step; a failing or hanging process fails the
   phase; none of the four graph kernels launched;
3d. the roofline terms without HLO (``launch.hlo_stats``, ``launch.dryrun``):
   (a) at the end of phase 3b, one more real train step of its model (16 x
   1024 tokens, one microbatch) counted by ``FlopCounterMode`` equal
   exactly to the same step under fake tensors in this process; the
   modeled compute and memory terms against phase 3b's median step; the
   card's peak memory against the fake ``MemTracker`` peak; (b) after
   phase 9, the dry run's BFS cell at phase 7's partition: a dense level's
   bytes and sends a rank equal the Communicator's at every level of
   phase 7's first root, its least kernel bytes at the HBM rate against
   the measured ms a level; (c) ``python -m repro_torch.launch.dryrun``
   for qwen3-1.7b's ``train_4k`` in a process of its own, started before
   the LM phases and read here: its row ``ok`` from fake tensors, and
   ``summary``'s tables of it;
3e. the LM side's tensor parallelism, after phase 3c (its state freed
   after): qwen3-1.7b sharded over (data 2, model 4) on simulated ranks
   (heads, kv heads, ff and vocab on the model axis): (a) bfloat16
   serving, ``generate(rules=, mesh=)`` of 8 prompts of 512 tokens and 32
   greedy tokens, prefill and decode ms, every model-axis call and each
   rank's bytes equal to the byte model (``lm.tp_calls``), the share of
   tokens equal to the unsharded run's, peak memory; in float32 with TF32
   off, prefill + teacher-forced decode against the unsharded forward at
   the reference's tolerance; (b) one float32 step (TF32 off) of the
   2-layer cut of phase 3b(c), 16 x 1024 tokens in the config's 4
   microbatches: loss and every leaf's gradient within 1e-5 of its largest
   against the unsharded step, the step's calls (remat's recompute, clip
   and AdamW) equal to the byte model; (c) 4 bfloat16 steps at full width
   through ``train.loop.train(mesh=)``: step ms, tokens a second, 6ND
   share, peak (over 75 GB: again on data 1 x model 4); (d) the butterfly
   step with the model axis inside in 4 gloo processes on the card on
   (data 2, model 2), the 2-layer cut, against the simulated ranks
   (records equal, every leaf within 1e-5); none of the four graph
   kernels launched; in the default run, 3c(d) and then 3e(d) run beside
   phase 4's host work (their processes hold the card; the Kronecker
   graph goes on it after they end) and log when joined;
3f. tensor parallelism for the other four families, after phase 3e (its
   state freed), on (data 2, model 4) simulated ranks: (a) mamba2-130m at
   its published size (24 SSM heads, 6 a rank), (b) whisper-medium at its
   published size (1500 seeded frames), (c) internvl2-26b at full width cut
   to 2 layers (256 seeded patches of 3200), each: bfloat16
   ``generate(rules=, mesh=)`` against the unsharded run of the same
   seeded weights (8 prompts; mamba2 1024 tokens, the others 256; 32 greedy
   tokens), prefill and decode ms, every model-axis call and each rank's
   bytes equal to ``lm.tp_calls``, the share of tokens equal, peak; in
   float32 with TF32 off, prefill + 15 teacher-forced decode steps against
   the unsharded forward at the reference's tolerance (mamba2 also on data
   1 x model 16, where its heads straddle the ranks); one float32 step of
   4 rows in 2 microbatches: loss and every leaf's gradient within 1e-5 of
   its largest against the unsharded gradient (mamba2's ``A_log``,
   ``dt_bias`` and ``wo`` within 2.5e-5: their float32 gradient moves
   about 1e-5 of its largest between one microbatch and two), the calls
   then the whole GSPMD step's equal to the byte model; (d) jamba-v0.1-52b
   at full width cut to one 8-layer period (13.3 B parameters), bfloat16
   serving of 4 prompts of 512 tokens and 16 new, the unsharded run first
   and on the host (the two are never on the card together): calls and
   bytes equal to the byte model; in every family's serving, every row's
   first greedy token equal to the unsharded run's and the prefill logits
   within 0.125, the share of all tokens equal logged; (e) none of the
   four graph kernels launched;
3g. FSDP (ZeRO-3) over the data axes beside tensor parallelism, after
   phase 3f (its state freed after): deepseek-7b (its config's FSDP) on
   (data 2, model 4) simulated ranks with ``rules_for_mesh(mesh,
   fsdp=True)``, each leaf with an ``embed`` dimension held as its data
   ranks' blocks and gathered unit by unit: (a) bfloat16 serving at its
   published size (30 layers, 6.9 B parameters) beside the tensor-parallel
   model of the same seeded weights, ``generate(rules=, mesh=)`` of 8
   prompts of 256 tokens and 16 greedy tokens, prefill and decode ms of
   both, the prefill logits and every token bit-equal to the
   tensor-parallel run's (else logged, and held to 3f's bounds), every
   FSDP and model-axis call and each rank's bytes equal to the byte models
   (``lm.fsdp_calls``, ``lm.tp_calls``), peak; (b) one float32 step (TF32
   off) of the 2-layer cut, 4 x 512 tokens in 2 microbatches, against the
   tensor-parallel step: loss and every leaf's gradient, and the
   parameters after AdamW, within 1e-5 of each leaf's largest, the records
   equal to the byte models; 3 bfloat16 steps at full width cut to 8
   layers through ``train.loop.train(mesh=, rules=)``, 8 x 1024 tokens in
   the config's 4 microbatches, after the same steps unsharded and
   tensor-parallel alone: the first loss bit-equal to tensor parallelism
   alone's, the others within 1e-2, every loss within 1e-2 of the
   unsharded run's; step ms of each, tokens a second, 6ND share, peak;
   (c) one FSDP GSPMD step in 4
   gloo processes on (data 2, model 2), the 2-layer cut, 4 x 256 tokens,
   against the simulated ranks (records equal, every gradient leaf within
   1e-5, each process's peak), beside phase 4 after 3e(d); none of the
   four graph kernels launched;
4. ETL: the Kronecker graph with edge weights in [1, 64] (its edge set is
   the unweighted graph's, so the BFS phases run on it), 1D partition over
   P simulated ranks, kernel layout, placement on the card; the 1024x1024
   torus the same way; small Kronecker graphs for the host oracles (scale
   12 for Brandes, 14 for k-core peeling) and for the triangle count
   (scale 15, the largest the reference's int32 bit index allows);
5. kernel checks at every call site: each kernel against its plain PyTorch
   version on the card, at the shapes the layout gives that site, exactly
   (integer kernels), with its time (CUDA events, L2 flushed before each
   launch), the plain version's time and the memory bound; the scatter at
   50 % and at 2 % random activity; the full gather on the route its
   planner picks and on the other; ``bitmap_or_reduce`` also at the shapes
   of the Rabenseifner reduce-scatter rounds, the xla all-gather reduce
   (K = P), the multi-source wave's buffer, the BC wave's buffer, the
   k-core peel bitmap and the triangle adjacency;
6. edge cases: the scatter and both gathers held exactly against their
   plain versions at the shapes and inputs a warp-per-block design can get
   wrong (one block, ragged grids, eb not a multiple of 16, misaligned
   views, the widest windows, hub blocks, bit 31, padding), the full gather
   at bitmaps of 64 to 600,000 words, in sorted and random order, on both
   routes;
7. Kronecker BFS, direction-optimizing, butterfly fanout 4, through the
   kernels: per-root time, trimmed GTEP/s, Graph500-style validation of
   every root, one root against the plain path bit for bit;
8. torus BFS, top-down (the windowed-gather path), the same way;
9. the launch count of every kernel over phases 7 and 8 (each must be > 0),
   and from the counts the launches per BFS of every call site;
10. the other syncs: Kronecker under ``adaptive``, ``sparse``,
    ``rabenseifner`` and ``xla``, torus under ``adaptive``; every root
    validated, one root against the dense butterfly bit for bit, that root
    traced (the same distances and kernel launches as untraced, the bytes
    each rank sent equal to the byte model level by level, the merge
    launches equal to what the trace's branches call for), the trace's
    cost in wall time, the level table, and the adaptive decision's cost;
10b. the hierarchical mesh: the P ranks as pods of 4 (pod 4 x data 4 at
    P = 16), ``axes=("pod", "data")``: Kronecker BFS from phase 7's first
    root, direction-optimizing, through the kernels, under all six syncs
    at the fanout and the butterfly at fanout 2, each against the one-axis
    run of the same root (distances, levels, edges examined and kernel
    launches equal), each traced with every rank's bytes equal to the byte
    model over the axes' sizes at every level, wall ms beside the one-axis
    run's; ``bitmap_or_reduce`` at the fanout-2 merge ``[P, 2, W]``; the
    analysis tools (``synthetic_shapes`` beside the real partition,
    ``step_bytes`` and ``prefill_corrections`` of the LM config); after
    phase 15, SSSP (adaptive, phase 12's first root) and CC (adaptive) on
    the same mesh, equal to phases 12 and 15 bit for bit, SSSP's bytes
    equal to the model at every iteration;
11. multi-source BFS: one 32-lane Kronecker wave, direction-optimizing,
    under ``butterfly`` and ``adaptive``, every lane against the
    single-source port's distances for its root; time, GTEP/s, memory;
12. SSSP under ``butterfly`` (4 roots), ``adaptive`` and ``sparse`` (2
    each) and the butterfly with delta-32 buckets (1): every root passes
    the Graph500 SSSP certificate on the card, the first root equals the
    butterfly's distances bit for bit under every sync, and, traced, each
    rank's bytes equal the byte model at every iteration;
13. BC: one 4-lane Kronecker wave, top-down, butterfly: each lane's levels
    equal the single-source BFS, each lane satisfies Brandes' identity
    (sum of dependencies = sum of (d - 1)); scale 12, 8 sources, against
    host Brandes within 1e-4;
14. PageRank under ``butterfly`` and ``sparse`` (delta mode), with
    PyTorch's deterministic algorithms on: the L1 residual of one more
    power step within ``2 tol d / (1 - d)``, sparse equal to dense bit for
    bit;
15. connected components under ``butterfly`` and ``adaptive``: labels
    equal the host's components;
16. k-core: the h-index fixed point at every vertex, on the card; scale
    14 against host peeling;
17. triangle counts at scale 15 against the host oracle;
18. the lane-packed repair (``repair_rows``, two 32-lane waves) at
    Kronecker scale 21, each row against the plain BFS from scratch;
19. streaming mutations on a copy of the Kronecker partition (the phases
    before and after keep the original): each rank's slack; an
    insert-only and a mixed (inserts and deletes) seeded batch, cut to the
    slack, patched in place; after each, cached BFS rows repaired under
    ``butterfly``, ``sparse`` and ``adaptive`` and SSSP rows under the
    butterfly (``dynamic.repair.repair_row``), every repaired row equal
    bit for bit to the from-scratch port traversal of the mutated
    partition and every SSSP row certified on the overlay's edges; then a
    root whose one-edge batch is proven unchanged with no launch;
20. a batch of 0.1 % of the edges refused by the in-place patch with every
    partition array byte-equal to before, then the compaction path
    (``overlay.compact()``, ``partition_1d``) whose fresh BFS and SSSP
    pass the certificates;
21. the query engine: 40 queries (32 distinct) in one wave, each row equal
    to the single-source BFS; ``sssp`` equal to phase 12; ``cc`` equal to
    the host components; a second engine on the same key builds nothing;
    the engine on the mutated copy, refreshed, answers for it;
22. ``bitmap_or_reduce`` at the repair's OR-sync shapes, exact and timed;
23. the query service (``GraphQueryService``) on a copy of the Kronecker
    partition: a seeded stream of about 100 requests (``bfs`` on 40 roots
    with duplicates in flight, ``closeness``, ``sssp``, ``cc``,
    ``pagerank``, then repeats), each answer equal to the direct path
    (the single-source kernel BFS, phases 12, 14 and 15), the duplicates
    folded, the repeats served from the cache with no wave; then a batch
    cut to the slack through ``apply_updates``, every cached row that
    survives or is repaired equal to the from-scratch traversal of the
    mutated copy;
24. the serving CLI (``serve_graph.main``) at Kronecker scale 20: two
    replicas, one killed by seeded chaos, mutation batches, the event log,
    SLOs and the stats: no future fails, one kill and one recovery, the
    reference's stats keys, every event valid, the SLO verdict written;
25. the cost-model profiler (``BFSQueryEngine.profile``) on the kernel
    path: the byte model equal to the Communicator's count, the per-level
    directions equal to phase 7's for the root, every supported cached
    program reconciled, the three kernels of the path launched;
26. one root of each cell of phases 7-8 under ``torch.profiler`` (device
    time by kernel and by call site, the device's busy share), after every
    timed run, with its per-level directions and launch counts against the
    same root run unprofiled; the Kronecker paths of phase 10 (and the
    butterfly at the adaptive one's root), the waves, BC, k-core, the
    triangle count and the repairs in the same way;
    then the torus roots timed again, to show what a profiler session
    costs the runs after it;
27. the call-site tables, the kernel line, and ``{"ok": true, ...}`` last.

Each path of phases 12-21 records its time, iterations, edges relaxed or
examined and their rate, bytes a rank and peak memory.  Every path is
driven with the launch counts set to 0 just before it and read just after;
BC, k-core, the triangle count, a repair with a taint phase under the
butterfly and the lane-packed repair must launch ``bitmap_or_reduce``.
Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing any result.  ``--out PATH`` also writes the results as
JSON.  ``--lm-only`` runs phases 1, 3, 3b, 3c, 3e, 3f's serving and 3g's
serving and gloo step alone, with 4 decode steps
and one train step under ``torch.profiler`` after the timed runs (the full
run profiles no LM step: a profiler session would precede the graph phases'
timings); ``--train-only`` runs phases 1, 3b, 3c, 3e, 3f's float32
steps and 3g's steps alone, the train step profiled.  ``--multi-card``, on a
machine with several cards, runs phase 3c(d) over nccl with one rank on
each card, then ``launch.train`` under ``torchrun`` with nccl, then phase
3e's serving (the float32 prefill logits and ``generate``'s greedy
tokens) and a float32 GSPMD step of the 2-layer cut over nccl, one model
rank on each card (data 1), then phase 3g's FSDP step of deepseek-7b's
2-layer cut on (data 2, model cards / 2), against the simulated ranks on
card 0, alone (NCCL refuses two ranks on one card, so the one-card run
uses gloo).

``--coverage lm`` and ``--coverage graph`` run, after phase 1's card line,
the paths that the default run leaves out (each under the 1200 s a run
is given), and end with the same ``{"ok": true, ...}`` line:

lm  [0] phase 3g(b)'s steps unsharded, tensor-parallel and with FSDP, the
    losses held to each other (``cov_loss``); [1] FSDP beside tensor
    parallelism for qwen3-moe (2 of 94 layers: serving, bfloat16 steps
    under Adafactor), gemma3-27b (one 5-local + 1-global period: prompts
    past the window served with the full cache and with the ring cache
    and in-place decode, tokens equal; steps), kimi-k2 (its dense layer
    and one MoE layer, serving, the two models apart), jamba, internvl2
    and whisper at 3f's cuts (serving; the float32 steps of the two that
    fit); [2] on deepseek-7b's 2-layer cut, an FSDP run failed and
    restarted bit-equal, its checkpoint restored onto data 8, the FSDP
    step on pod x data x model against data 2 x model 4; [3] the four
    families' butterfly steps against their GSPMD steps, their restarts
    (jamba's, its experts cut, its training), whisper's split kv heads,
    the gloo family group; [4] ``serve_lm`` for every arch and
    ``launch.train --grad-sync butterfly`` on the card against the CPU,
    GPipe on (stage 4, data 2), the (pod, data) gradient syncs against
    the CPU, the prefill's flops fake against real. ``--groups`` picks
    groups; with ``--multi-card``, [5] 3f's four families' serving over
    nccl, one model rank a card, against the simulated ranks.
graph  phase 7's partition on pod 4 x data 4: [6] the 32-lane wave under
    butterfly and adaptive, a 4-lane BC wave, PageRank, k-core (scale
    14), triangles (scale 15), the query engine and a streaming repair,
    each against the one-axis run of the same roots and sync, each traced
    run's bytes equal to the byte model over the axes' sizes; [8] the
    per-group branches of the sparse and adaptive syncs on the straddle
    inputs against the CPU; [7] every kernel call site of [6] and [8] held
    exactly against its plain version and timed, each path profiled for
    its merges' in-run ms; [9] ``serve_graph.main`` at ``--cli-scale``
    traced, swapped, its updates recorded, and with two replicas under
    the batch faults, a stall and a kill, the console's routes fetched
    over HTTP while each serves; the updates replayed by ``bfs_run``;
    ``fault_exemplar`` over the events; BC served by the service against
    phase 13's wave.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 3b runs with PyTorch's deterministic algorithms, for which cuBLAS
# needs a fixed workspace: it is read when cuBLAS first starts, before any
# phase runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
L2_FLUSH_BYTES = 256 << 20  # over the 50 MB L2
REPLACES = {
    "frontier_gather_full": "src/repro/kernels/frontier_gather.py:77",
    "frontier_gather": "src/repro/kernels/frontier_gather.py:33",
    "frontier_scatter": "src/repro/kernels/frontier_scatter.py:62",
    "bitmap_or_reduce": "src/repro/kernels/bitmap_merge.py:27",
}
SOURCES = {
    "frontier_gather_full": "src/repro_torch/kernels/csrc/frontier_gather.cu",
    "frontier_gather": "src/repro_torch/kernels/csrc/frontier_gather.cu",
    "frontier_scatter": "src/repro_torch/kernels/csrc/frontier_scatter.cu",
    "bitmap_or_reduce": "src/repro_torch/kernels/csrc/bitmap_merge.cu",
}
# the module of the port that holds each kernel's wrapper
WRAPPERS = {"frontier_gather_full": "frontier_gather", "frontier_gather": "frontier_gather",
            "frontier_scatter": "frontier_scatter", "bitmap_or_reduce": "bitmap_merge"}
# the gather a layout's ``*gather_full`` flag selects
GATHER = {1: "frontier_gather_full", 0: "frontier_gather"}
# the site of each kernel whose row stands for it in the kernel line
MAIN_SITE = {
    "frontier_gather_full": ("kronecker", "tdg_src", None),
    "frontier_gather": ("torus", "tdg_src", None),
    "frontier_scatter": ("kronecker", "tds", 0.5),
    "bitmap_or_reduce": ("kronecker", "merge", None),
}
# roots of each other sync's cell (adaptive Kronecker: 4x), lanes of the wave
SYNC_ROOTS = 2
LANES = 32
# the weighted paths: the Kronecker graph's largest weight (the CLI's SSSP
# default), SSSP roots per sync and the bucket width of the delta run, and
# the lanes of the Brandes wave (each lane takes about 8 GB at scale 23)
WEIGHT = 64
SSSP_ROOTS = {"butterfly": 4, "adaptive": 2, "sparse": 2}
SSSP_DELTA = 32
BC_LANES = 4
# k-core's profile runs its first rounds only: the whole run (about 1550
# rounds, 160,000 device operations) costs a minute or more of trace
# processing, and every round launches the same peel waves
KCORE_PROFILE_ROUNDS = 200
# the mutation phases: undirected inserts and deletes sampled for each
# in-place batch (the inserts cut to the ranks' slack), cached roots per
# row kind, the syncs of the BFS repairs, the share of the edges inserted
# by the batch that overflows the slack, and the lane wave's Kronecker
# scale (its replicated [n_rows, 32] columns, about five 16-rank copies,
# fit 80 GB up to scale 21; PERF.md section 4) and rows (two waves)
MUTATION_INSERTS = 64
MUTATION_DELETES = 32
REPAIR_ROOTS = 2
REPAIR_SYNCS = ("butterfly", "sparse", "adaptive")
OVERFLOW_FRACTION = 1e-3
WAVE_SCALE = 21
WAVE_SUSPECTS = 40
# what the profiler calls the device work of each wrapper
DEVICE_NAMES = {"frontier_gather_full": ("::gather_full",),
                "frontier_gather": ("::gather_window_kernel",),
                "frontier_scatter": ("::scatter_kernel", "Memset"),
                "bitmap_or_reduce": ("::or_reduce_kernel",)}
# the layout plane each expansion-op call reads, by argument position
SITE_ARG = {"frontier_gather_full": 1, "frontier_gather": 2, "frontier_scatter": 2}


_HELD = threading.local()


def log(msg: str) -> None:
    """Print ``msg``; in a :class:`Beside` thread, hold it for its join."""
    held = getattr(_HELD, "lines", None)
    if held is not None:
        held.append(msg)
    else:
        print(msg, flush=True)


class Beside:
    """``fn(*args)`` in a thread beside the phases that follow, its log
    lines held until :meth:`join` prints them (so that they stay in one
    block).  ``join`` waits, prints, and returns ``fn``'s result or raises
    its exception; a second ``join`` returns the same at once."""

    def __init__(self, fn, *args):
        self.lines, self.result, self.error, self.printed = [], None, None, False
        self.t0 = time.perf_counter()

        def run():
            _HELD.lines = self.lines
            try:
                self.result = fn(*args)
            except BaseException as e:  # raised again by join
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if not self.printed:
            self.printed = True
            for line in self.lines:
                print(line, flush=True)
        if self.error is not None:
            raise self.error
        return self.result


def time_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` over ``reps`` launches, each timed
    alone by CUDA events after the L2 is flushed (a caller in the BFS finds
    the layout planes cold), after a warm-up.  The flush reads a buffer
    larger than the L2, so it leaves no dirty lines to write back, and
    keeps the device busy while the host enqueues the launch, so host time
    is not counted; what a pair of events costs around one launch is not
    taken off (``event_floor_ms`` measures it)."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    events = []
    for _ in range(reps):
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def event_floor_ms(reps: int = 50) -> float:
    """What ``time_ms`` reads for a launch that does almost nothing (a
    4-byte fill): the floor under every kernel time it gives."""
    import torch

    x = torch.zeros(1, dtype=torch.int32, device="cuda")
    return time_ms(x.zero_, reps)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def random_words(shape, gen, dev, density=0.5):
    """int32 words whose bits are set with probability ``density``."""
    import torch

    if density == 0.5:
        raw = torch.randint(0, 256, (*shape, 4), dtype=torch.uint8, generator=gen,
                            device=dev)
        return raw.view(torch.int32).reshape(shape)
    from repro_torch.core import frontier as fr

    bits = torch.rand((*shape[:-1], shape[-1] * 32), generator=gen, device=dev) < density
    return fr.pack(bits)


def distinct_word_bytes(word_idx) -> int:
    """Bytes of the distinct bitmap words ``word_idx[P, ...]`` reads, each
    rank's words counted apart: what a gather must read at the least (the
    count the profiler's tally uses, ``kernels/bounds.py``)."""
    from repro_torch.kernels import bounds

    return bounds.distinct_word_bytes(word_idx)


def scatter_least_bytes(active, block_win, dst_local, out_words: int) -> int:
    """What a scatter must move at the least: ``active``, ``block_win`` and
    the ``out_words`` int32 output words whole, and of ``dst_local`` the
    32-byte sectors that hold an active slot (an inactive slot's offset
    need not be read; a sector is the least the memory delivers)."""
    from repro_torch.kernels import bounds

    return bounds.scatter_least_bytes(active, block_win, dst_local, out_words)


def site_launches(counts, meta, n_runs):
    """Launches per BFS of every call site of the expansion ops, from the
    launch counts of ``n_runs`` BFS runs over one layout (``meta``).  A push
    level launches one gather (of ``tdg_src``) and one scatter (``tds``); a
    pull level two gathers (``in_src_blocks``, ``pug_dst``) and one scatter
    (``pus``); so the pull levels are the gathers less the scatters."""
    full, win = counts["frontier_gather_full"], counts["frontier_gather"]
    pull = full + win - counts["frontier_scatter"]
    push = counts["frontier_scatter"] - pull
    sites = {
        (GATHER[meta["gather_full"]], "tdg_src"): push,
        ("frontier_gather_full", "in_src_blocks"): pull,
        (GATHER[meta["pull_gather_full"]], "pug_dst"): pull,
        ("frontier_scatter", "tds"): push,
        ("frontier_scatter", "pus"): pull,
        ("bitmap_or_reduce", "merge"): counts["bitmap_or_reduce"],
    }
    for name in GATHER.values():
        if sum(n for (k, _), n in sites.items() if k == name) != counts[name]:
            raise AssertionError(f"{name}: {counts} do not split into push "
                                 f"and pull levels under {meta}")
    if min(push, pull) < 0:
        raise AssertionError(f"{counts} give {push} push and {pull} pull levels")
    return {k: v / n_runs for k, v in sites.items()}


def wrapper(name):
    """The wrapper of kernel ``name`` in the ``repro_torch`` imported now."""
    import importlib

    return getattr(importlib.import_module(f"repro_torch.kernels.{WRAPPERS[name]}"), name)


def site_cases(cell, parts, gen, dev, fanout, activities=(0.5, 0.02)):
    """The input of every kernel at every site where one cell's main path
    calls it, on random bitmaps and activity: ``name``, ``cell``, ``plane``,
    ``activity`` (scatter), ``args`` and ``kwargs`` (the same for the
    wrapper and its plain version) and ``bytes``, the least the function
    must move: every input read once and the output written once, but a
    gather reads only the distinct bitmap words its indices reach and the
    scatter only the offset sectors that hold an active slot."""
    import torch

    a, m, p = parts["arrays"], parts["layout"].meta, parts["pg"].p
    cases = []

    def gather(plane, full, ww, ws, words_pad):
        words = random_words((p, m[words_pad]), gen, dev)
        src = a[plane]
        if full:
            cases.append(dict(name="frontier_gather_full", cell=cell, plane=plane,
                              args=(words, src), kwargs={},
                              ids_sorted=plane in m["sorted_planes"],
                              bytes=distinct_word_bytes(src >> 5) + nbytes(src)
                              + src.numel()))
            return
        ws, ww = a[ws], m[ww]
        window_words = (ws.long() * ww)[..., None] + torch.arange(ww, device=dev)
        cases.append(dict(name="frontier_gather", cell=cell, plane=plane,
                          args=(words, ws, src), kwargs=dict(ww=ww),
                          bytes=distinct_word_bytes(window_words) + nbytes(ws, src)
                          + src.numel()))

    pulls = parts["mode"] != "top_down"
    gather("tdg_src", m["gather_full"], "gather_ww", "tdg_ws", "gather_words_pad")
    if pulls:
        gather("in_src_blocks", True, None, None, "gather_words_pad")
        gather("pug_dst", m["pull_gather_full"], "pull_gather_ww", "pug_ws",
               "pull_gather_words_pad")
    n_windows, ww = m["scatter_windows"], m["scatter_ww"]
    for prefix in ("tds", "pus") if pulls else ("tds",):
        win, dst = a[prefix + "_win"], a[prefix + "_dst"]
        for act in activities:
            active = torch.rand(dst.shape, generator=gen, device=dev) < act
            cases.append(dict(name="frontier_scatter", cell=cell, plane=prefix,
                              activity=act, args=(active, win, dst),
                              kwargs=dict(n_windows=n_windows, ww=ww),
                              bytes=scatter_least_bytes(active, win, dst,
                                                        p * n_windows * ww)))
    stack = random_words((p, fanout, parts["pg"].n_words), gen, dev)
    cases.append(dict(name="bitmap_or_reduce", cell=cell, plane="merge",
                      args=(stack,), kwargs={},
                      bytes=nbytes(stack) // fanout * (fanout + 1)))
    return cases


def site_key(case):
    return {k: case[k] for k in ("cell", "plane", "activity", "path") if k in case}


def gather_full_routes(fn, ids_sorted):
    """``(label, kwargs)`` of each route of ``fn``, a tree's
    ``frontier_gather_full``, to hold and time on ids in sorted or random
    order: the planner's first, then the other, each reached through the
    wrapper's ``ids_sorted``.  A tree whose wrapper has one route has one,
    "single"."""
    import inspect

    if "ids_sorted" not in inspect.signature(fn).parameters:
        return [("single", {})]
    plan = sys.modules[fn.__module__].plan_gather_full
    return [(plan(s), dict(ids_sorted=s)) for s in (ids_sorted, not ids_sorted)]


def case_routes(case, fn):
    """The routes of one site case: the full gather's where the wrapper has
    several, else the one call."""
    if case["name"] == "frontier_gather_full":
        return gather_full_routes(fn, case["ids_sorted"])
    return [("single", {})]


def check_exact(name, got, want, what):
    """Raise unless ``got`` equals ``want`` in shape, type and value;
    return the largest absolute difference."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, "
                             f"plain {want.dtype}{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


def check_kernel(case, reps=20):
    """Hold the wrapper of ``case["name"]`` against its plain version
    exactly on the case's inputs and time both, on each of the wrapper's
    routes (``route_ms``; ``ms`` is the planner's, the main path's).
    Returns the record for the kernel line, with the site's keys (cell,
    plane, activity) beside."""
    import torch

    from repro_torch.kernels import ref

    name, args, kwargs = case["name"], case["args"], case["kwargs"]
    fn, plain_fn = wrapper(name), getattr(ref, name)
    plain = lambda: plain_fn(*args, **kwargs)  # noqa: E731
    want = plain()
    route_ms, err = {}, 0
    for label, extra in case_routes(case, fn):
        kernel = lambda: fn(*args, **kwargs, **extra)  # noqa: E731
        got = kernel()
        torch.cuda.synchronize()
        err = max(err, check_exact(name, got, want, f"{site_key(case)} {label}"))
        route_ms[label] = time_ms(kernel, reps)
    plan = next(iter(route_ms))
    ms = route_ms[plan]
    plain_ms = time_ms(plain, max(2, reps // 4))
    moved = case["bytes"]
    rec = dict(name=name, route="cuda", source=SOURCES[name],
               replaces=REPLACES[name], launches=0, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes", library_ms=None, plan=plan, route_ms=route_ms,
               shape=" ".join(f"{tuple(t.shape)}" for t in args),
               bytes=moved, **site_key(case))
    others = "".join(f", {k} {v:.4f} ms" for k, v in route_ms.items() if k != plan)
    log(f"  {name} {site_key(case)}: exact; {ms:.4f} ms on {plan}{others} (plain "
        f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB) "
        f"at {rec['shape']}")
    return rec


def _placed(t, misalign):
    """``t``, or a contiguous copy whose first element is 1 element past a
    16-byte boundary."""
    import torch

    if not misalign:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _sorted_offsets(p, nb, eb, bits, gen, dev, *, ordered=True):
    """``dst_local``-like offsets: random in the window, sorted within each
    block as the layout sorts them, with a random tail of padding slots
    (offset ``bits``)."""
    import torch

    x = torch.randint(0, bits, (p, nb, eb), generator=gen, device=dev, dtype=torch.int32)
    if ordered:
        x = x.sort(dim=-1).values
    pad = torch.randint(0, eb // 4 + 1, (p, nb, 1), generator=gen, device=dev)
    x = torch.where(torch.arange(eb, device=dev) >= eb - pad, bits, x)
    if not ordered:
        x = x[..., torch.randperm(eb, generator=gen, device=dev)]
    return x.to(torch.int32).contiguous()


SCATTER_CASES = [
    # P, NB, eb, ww, windows, activity, misaligned, hub, sorted
    (1, 1, 512, 64, 4, 1.0, False, False, True),
    (16, 37, 512, 64, 64, 0.5, False, True, True),
    (16, 2053, 512, 64, 1500, 0.02, False, True, True),
    (16, 211, 512, 64, 300, 0.0, False, False, True),
    (4, 57, 128, 8, 40, 0.5, False, True, True),
    (4, 33, 200, 8, 40, 0.5, False, True, True),
    (4, 33, 512, 64, 40, 1.0, True, True, True),
    (2, 9, 512, 12288, 3, 0.5, False, True, True),
    (2, 9, 200, 12288, 3, 0.02, True, False, True),
    (16, 301, 512, 64, 200, 0.5, False, False, False),
    (1, 5, 512, 8, 2, 1.0, False, True, True),
]
GATHER_CASES = [
    # P, NB, eb, ww, words, word density, misaligned, hub
    (1, 1, 512, 8, 64, 0.5, False, False),
    (16, 37, 512, 8, 1024, 0.02, False, True),
    (16, 2053, 512, 32, 4096, 0.5, False, True),
    (4, 57, 128, 64, 1024, 1.0, False, True),
    (4, 33, 200, 8, 256, 0.5, False, True),
    (4, 33, 200, 4096, 16384, 0.0, False, False),
    (4, 33, 512, 8, 256, 0.5, True, True),
    (2, 9, 512, 4096, 8192, 0.02, True, True),
    (2, 5, 512, 12288, 24576, 0.5, False, True),
]
GATHER_FULL_CASES = [
    # P, NB, eb, words, word density, misaligned, hub, sorted ids; bitmaps
    # from 256 B to 2.4 MB (a rank's at Kronecker scale 23 is 1.1 MB), each
    # run on both routes
    (1, 1, 512, 64, 0.5, False, False, False),
    (16, 37, 512, 8192, 0.02, False, True, True),
    (4, 33, 200, 1001, 1.0, True, True, False),
    (2, 45, 512, 40000, 0.5, True, True, False),
    (4, 100, 128, 131072, 0.5, False, True, True),
    (16, 64, 512, 262144, 0.5, False, True, True),
    (3, 50, 200, 200000, 0.5, False, True, False),
    (2, 64, 512, 300000, 0.5, False, True, False),
    (16, 9, 512, 524288, 0.5, True, True, False),
    (2, 64, 512, 524289, 0.5, False, True, True),
    (4, 21, 200, 600000, 0.5, True, True, False),
    (4, 21, 200, 300000, 0.5, True, True, True),
]


def full_gather_inputs(case, gen, dev):
    """``words`` and ``src`` of one ``GATHER_FULL_CASES`` case.  Bit 31 of
    the last word is set in every other rank and the last slot of every
    rank reads it; a hub block reads nothing else."""
    import torch

    p, nb, eb, n_words, density, misalign, hub, ordered = case
    bits = n_words * 32
    words = random_words((p, n_words), gen, dev, density)
    words[::2, -1] |= -(1 << 31)
    src = torch.randint(0, bits, (p, nb, eb), generator=gen, device=dev,
                        dtype=torch.int32)
    if ordered:
        src = src.sort(dim=-1).values
    src[:, -1, -1] = bits - 1
    if hub:
        src[:, 0] = bits - 1
    return _placed(words, misalign), _placed(src.contiguous(), misalign)


def edge_cases(gen, dev):
    """Phase 6: the scatter and both gathers exactly against their plain
    versions on the cases above, the full gather on each of its routes.  A
    hub block sends all its slots to bit 31 of its window's (or bitmap's)
    last word; windows no block covers stay zero."""
    import torch

    from repro_torch.kernels import frontier_gather, frontier_scatter, ref

    for case in SCATTER_CASES:
        p, nb, eb, ww, n_windows, act, misalign, hub, ordered = case
        bits = ww * 32
        win = torch.randint(0, n_windows, (p, nb), generator=gen, device=dev,
                            dtype=torch.int32).sort(dim=1).values.contiguous()
        dst = _sorted_offsets(p, nb, eb, bits, gen, dev, ordered=ordered)
        active = torch.rand((p, nb, eb), generator=gen, device=dev) < act
        if hub:
            dst[:, 0] = bits - 1
            active[:, 0] = True
        active, dst = _placed(active, misalign), _placed(dst, misalign)
        got = frontier_scatter.frontier_scatter(active, win, dst,
                                                n_windows=n_windows, ww=ww)
        want = ref.frontier_scatter(active, win, dst, n_windows, ww)
        if not torch.equal(got, want):
            raise AssertionError(f"frontier_scatter differs from its plain version "
                                 f"on edge case {case}")
    for case in GATHER_CASES:
        p, nb, eb, ww, n_words, density, misalign, hub = case
        bits = ww * 32
        words = random_words((p, n_words), gen, dev, density)
        ws = torch.randint(0, n_words // ww, (p, nb), generator=gen, device=dev,
                           dtype=torch.int32)
        src = torch.randint(0, bits, (p, nb, eb), generator=gen, device=dev,
                            dtype=torch.int32)
        if hub:
            src[:, 0] = bits - 1
        src = _placed(src, misalign)
        got = frontier_gather.frontier_gather(words, ws, src, ww=ww)
        want = ref.frontier_gather(words, ws, src, ww)
        if not torch.equal(got, want):
            raise AssertionError(f"frontier_gather differs from its plain version "
                                 f"on edge case {case}")
    routes = {}
    for case in GATHER_FULL_CASES:
        words, src = full_gather_inputs(case, gen, dev)
        want = ref.frontier_gather_full(words, src)
        fn = frontier_gather.frontier_gather_full
        for label, kwargs in gather_full_routes(fn, case[7]):
            if not torch.equal(fn(words, src, **kwargs), want):
                raise AssertionError(f"frontier_gather_full ({label}) differs from "
                                     f"its plain version on edge case {case}")
            routes[label] = routes.get(label, 0) + 1
    log(f"  {len(SCATTER_CASES)} scatter, {len(GATHER_CASES)} windowed-gather and "
        f"{len(GATHER_FULL_CASES)} full-gather cases exact (full gather by route: "
        f"{routes})")
    return len(SCATTER_CASES) + len(GATHER_CASES) + len(GATHER_FULL_CASES)


def validate(parts, root, d_owned) -> None:
    """Graph500-style checks of one BFS tree (per-rank distances
    ``d_owned``) against the graph of ``parts`` (from :func:`etl`), on the
    device that holds them: the root at 0, the reached set equal to the
    root's component, no edge spanning more than one level, and every
    reached vertex but the root with a neighbour one level up."""
    import torch

    from repro_torch.core.bfs import INF

    src, dst, labels, slot = parts["check"]
    dist = d_owned.reshape(-1)[slot].long()
    reached = dist < INF
    if int(dist[root]) != 0:
        raise AssertionError(f"root {root}: d[root] = {int(dist[root])}")
    if not torch.equal(reached, labels == labels[root]):
        raise AssertionError(f"root {root}: reached set != its component")
    du, dv = dist[src], dist[dst]
    both = reached[src] & reached[dst]
    if bool((both & ((du - dv).abs() > 1)).any()):
        raise AssertionError(f"root {root}: an edge spans more than one level")
    has_parent = torch.zeros(dist.numel(), dtype=torch.uint8, device=dist.device)
    has_parent.scatter_reduce_(0, dst, (both & (du == dv - 1)).to(torch.uint8), "amax")
    orphan = reached & (has_parent == 0)
    orphan[root] = False
    if bool(orphan.any()):
        raise AssertionError(f"root {root}: {int(orphan.sum())} reached vertices "
                             f"have no neighbour one level up")


def etl(label, make_graph, ranks, dev, mode, before_place=None):
    """Generate, partition, lay out and place one graph; returns its parts.
    ``before_place()`` is called before anything goes on the card (its
    time is no stage's)."""
    import numpy as np
    import torch

    from repro_torch.core import bfs
    from repro_torch.graph import csr, partition
    from repro_torch.kernels import blocks

    t = [time.perf_counter()]
    g = make_graph()
    t.append(time.perf_counter())
    pg = partition.partition_1d(g, ranks)
    t.append(time.perf_counter())
    layout = blocks.build_bfs_layout(pg)
    t.append(time.perf_counter())
    labels = csr.connected_components(g)
    t.append(time.perf_counter())
    wait_s = 0.0
    if before_place is not None:
        before_place()
        wait_s = time.perf_counter() - t[-1]
    arrays = bfs.place_arrays(pg, layout, device=dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    s = [b - a for a, b in zip(t, t[1:])]
    s[-1] -= wait_s
    dev_bytes = nbytes(*arrays.values())
    # what validate() reads: the edges, the components, and the slot of each
    # vertex in the flat [P, vmax] distances
    check = tuple(torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
                  for a in (g.src, g.dst, labels)) + (vertex_slots(pg, dev),)
    # what the SSSP certificate reads besides: each edge's weight
    weights = (torch.as_tensor(g.weights.astype(np.int64), device=dev)
               if g.weighted else None)
    log(f"  {label}: n={g.n:,} m={g.n_edges:,} directed"
        f"{', weighted' if g.weighted else ''}, P={ranks}, "
        f"emax={pg.emax:,}, n_words={pg.n_words:,}; generate {s[0]:.1f} s, "
        f"partition {s[1]:.1f} s, layout {s[2]:.1f} s, components {s[3]:.1f} s, "
        f"place {s[4]:.1f} s"
        f"{f' (after {wait_s:.1f} s waiting for the processes beside it)' if before_place else ''}"
        f"; {dev_bytes / 1e9:.2f} GB on the card; meta {layout.meta}")
    return dict(g=g, pg=pg, layout=layout, labels=labels, arrays=arrays, check=check,
                weights=weights, etl_s=s, device_bytes=dev_bytes, mode=mode)


@contextlib.contextmanager
def site_ranges(sites):
    """Inside the block, every kernel call of the expansion ops runs in a
    profiler range named for its call site: ``sites`` maps the data pointer
    of the layout plane a call reads to the range's name."""
    from torch.profiler import record_function

    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in SITE_ARG}

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function(sites.get(args[SITE_ARG[name]].data_ptr(), name)):
                return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(ops, name, labelled(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def direction_log():
    """Inside the block, the direction of each BFS level that runs through
    the kernels ("push" or "pull") is appended to the list yielded."""
    from repro_torch.kernels import ops

    seq = []
    saved = {name: getattr(ops, name) for name in ("expand_push", "expand_pull")}

    def logged(name, fn):
        def call(*args, **kwargs):
            seq.append(name.split("_")[1])
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(ops, name, logged(name, fn))
    try:
        yield seq
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def run_lengths(seq):
    """``["push", "push", "pull"]`` -> ``"push x2, pull x1"``."""
    out = []
    for d in seq:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return ", ".join(f"{d} x{n}" for d, n in out)


def site_label(cell, name, plane):
    return f"{cell}:{name}@{plane}"


def call_sites(cell, meta, arrays):
    """Profiler range name of every expansion-op call site of one cell, by
    the data pointer of the layout plane the call reads."""
    planes = [(GATHER[meta["gather_full"]], "tdg_src", "tdg_src"),
              ("frontier_gather_full", "in_src_blocks", "in_src_blocks"),
              (GATHER[meta["pull_gather_full"]], "pug_dst", "pug_dst"),
              ("frontier_scatter", "tds_dst", "tds"),
              ("frontier_scatter", "pus_dst", "pus")]
    return {arrays[key].data_ptr(): site_label(cell, name, plane)
            for name, key, plane in planes}


def device_breakdown(label, run, wall_ms, sites, top=8):
    """Where one BFS's time goes: device time by kernel name and by call
    site (``sites``: plane pointer -> range name; the merge has one site)
    from ``torch.profiler`` over one run, and the device's busy share of
    ``wall_ms``, the same run's time unprofiled (the profiler slows the
    host, not the kernels).  A site's time is the device span of its
    profiler range (its first launch's start to its last launch's end),
    capped by the device time of every launch of its kernel in the run
    (the scatter's with every memset): where the host lags the device, the
    span also counts the gap between the scatter's zero-fill and its
    kernel, and the cap does not.  The run is made once unprofiled first;
    ``levels`` holds both runs' per-level directions and launch counts and
    the launches the profiler saw of each kernel.  Where it saw fewer
    launches of a kernel than the wrapper counted (it can drop a record), a
    site of that kernel has no time (``ms`` None): its count of ranges
    would divide the device time of fewer launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    # the same run unprofiled first: its levels' directions and launches
    # against the profiled run's, and the profiler's count of each kernel
    torch.cuda.synchronize()
    build.reset_launches()
    with direction_log() as plain_dirs:
        run()
    torch.cuda.synchronize()
    plain_launches = dict(build.LAUNCHES)
    build.reset_launches()
    with site_ranges(sites), direction_log() as dirs, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    names = set(sites.values())
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.is_user_annotation and e.key not in names]
    kernels.sort(key=lambda e: -e.self_device_time_total)

    def launched(name):
        return [e for e in kernels if any(k in e.key for k in DEVICE_NAMES[name])]

    calls = {e.key: e.count for e in events if e.key in names
             and e.device_type.name == "CPU"}
    seen = {name: sum(e.count for e in launched(name)
                      if not any(k in e.key for k in ("Memset", "memset")))
            for name in DEVICE_NAMES}
    per_site = {}
    for e in events:
        if e.key in calls and e.device_type.name == "CUDA":
            name = e.key.split(":")[1].split("@")[0]
            span = e.self_device_time_total / 1e3
            cap = sum(k.self_device_time_total for k in launched(name)) / 1e3
            per_site[e.key] = dict(ms=min(span, cap) if seen[name] == launches[name]
                                   else None, span_ms=span, count=calls[e.key])
    levels = dict(profiled=dirs, unprofiled=plain_dirs, same=dirs == plain_dirs,
                  launches=launches, unprofiled_launches=plain_launches,
                  profiler_saw=seen)
    log(f"  {label} levels: profiled {run_lengths(dirs)}; unprofiled "
        f"{'the same' if dirs == plain_dirs else run_lengths(plain_dirs)}; "
        f"launches counted profiled {launches}, unprofiled {plain_launches}; "
        f"kernels the profiler saw {seen}")
    merge = launched("bitmap_or_reduce")
    if merge:
        per_site[site_label(label, "bitmap_or_reduce", "merge")] = dict(
            ms=sum(e.self_device_time_total for e in merge) / 1e3,
            count=sum(e.count for e in merge))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
            for e in kernels[:top]]
    if not rows:
        log(f"  {label} profile: the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_busy_ms=None, top=[], sites={},
                    levels=levels)
    log(f"  {label} profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall ({busy_ms / wall_ms:.1%}); device time by kernel:")
    for name, ms, n in rows:
        log(f"    {ms:9.3f} ms  {n:6d}x  {name}")
    port = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
            for name in DEVICE_NAMES for e in launched(name)]
    log("  the port's kernels and memsets:")
    for name, ms, n in port:
        log(f"    {ms:9.3f} ms  {n:6d}x  {name}")
    log("  device time by call site:")
    for name, rec in sorted(per_site.items()):
        span = "" if rec.get("span_ms") is None else f" (span {rec['span_ms']:.3f} ms)"
        ms = "not measured" if rec["ms"] is None else f"{rec['ms']:9.3f} ms"
        log(f"    {ms}  {rec['count']:6d}x  {name}{span}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top=rows, port=port,
                sites=per_site, levels=levels)


def run_bfs(label, parts, cfg, n_roots, seed, dev):
    """Time ``cfg`` over distinct largest-component roots with the CLI's
    protocol (``bfs_run.time_roots``), validate every root, and hold one
    root against the plain path bit for bit.  Returns the summary, the
    kernel launches of the timed and warm-up runs, a function that profiles
    one root, and one that repeats the timed runs."""
    import numpy as np
    import torch

    from repro_torch.core import bfs, butterfly, collectives
    from repro_torch.graph import csr
    from repro_torch.kernels import build
    from repro_torch.launch import bfs_run

    g, pg, layout, arrays = parts["g"], parts["pg"], parts["layout"], parts["arrays"]
    roots = csr.largest_component_roots(
        g, n_roots, np.random.default_rng(seed), labels=parts["labels"]).tolist()
    fn = bfs.build_bfs_fn(pg, cfg, layout, device=dev)
    build.reset_launches()
    runs, trimmed_ms, trimmed_gteps = bfs_run.time_roots(fn, arrays, roots, dev)
    launches = dict(build.LAUNCHES)
    n_runs = len(roots) + 1

    for r, (dt, levels, scanned, d_owned) in zip(roots, runs):
        validate(parts, r, d_owned)
        log(f"  root {r}: {dt * 1e3:.3f} ms, {levels} levels, {scanned:.0f} "
            f"edges examined, {scanned / dt / 1e9:.4f} GTEP/s; valid")

    # one root on the plain path, on the card, bit for bit; the kernel run
    # again with a communicator to read the merge's bytes per rank
    comm = collectives.Communicator(pg.p, dev)
    d_k, lv_k, sc_k = fn(arrays, roots[0], comm)
    plain = bfs.build_bfs_fn(pg, dataclasses.replace(cfg, use_kernels=False),
                             device=dev)
    d_p, lv_p, sc_p = plain(arrays, roots[0])
    if not (torch.equal(d_k, d_p) and lv_k == lv_p and sc_k == sc_p):
        raise AssertionError(f"{label}: kernel path != plain path at root "
                             f"{roots[0]}: levels {lv_k}/{lv_p}, scanned "
                             f"{sc_k}/{sc_p}")
    if cfg.sync == "butterfly":
        want = lv_k * butterfly.bytes_per_node_allreduce(pg.p, cfg.fanout,
                                                         pg.n_words * 4)
        if not np.all(comm.bytes_sent == want):
            raise AssertionError(f"{label}: merge bytes per rank "
                                 f"{comm.bytes_sent} != {want}")
    summary = dict(
        roots=len(roots), first_root=roots[0], ms=[x[0] * 1e3 for x in runs],
        levels=[x[1] for x in runs], scanned=[x[2] for x in runs],
        trimmed_ms=trimmed_ms, trimmed_gteps=trimmed_gteps,
        merge_bytes_per_rank=int(comm.bytes_sent[0]),
        launches_per_bfs={k: v / n_runs for k, v in launches.items()},
        site_launches_per_bfs={
            site_label(label, *k): v
            for k, v in site_launches(launches, layout.meta, n_runs).items() if v},
    )
    log(f"  {label}: {len(roots)} roots valid; trimmed mean "
        f"{summary['trimmed_ms']:.3f} ms, {summary['trimmed_gteps']:.4f} GTEP/s "
        f"(first reading); kernel path == plain path at root {roots[0]} "
        f"({lv_k} levels, {sc_k:.0f} edges); merge sent "
        f"{summary['merge_bytes_per_rank']:,} B per rank in that BFS")
    return (summary, launches,
            lambda: device_breakdown(label, lambda: fn(arrays, roots[0]),
                                     runs[0][0] * 1e3,
                                     call_sites(label, layout.meta, arrays)),
            lambda: bfs_run.time_roots(fn, arrays, roots, dev))


def site_table(rows, cells):
    """Fill each phase-4 row with its site's launches per BFS, its device
    time per launch inside the profiled BFS, and (that time - bound) x
    launches, the time the BFS loses to the kernel at that site; log the
    table."""
    log("  kernel@site (cell, activity): launches/BFS, ms per launch in the "
        "BFS | isolated ms | bound ms (MB) | (BFS ms - bound) x launches")
    for rec in rows:
        summary = cells[rec["cell"]]
        name = site_label(rec["cell"], rec["name"], rec["plane"])
        rec["launches_per_bfs"] = summary["site_launches_per_bfs"].get(name, 0.0)
        prof = summary.get("profile", {}).get("sites", {}).get(name, {})
        rec["bfs_ms_per_launch"] = (prof["ms"] / prof["count"]
                                    if prof.get("count") and prof.get("ms") else None)
        rec["gap_ms"] = ((rec["bfs_ms_per_launch"] - rec["bound_ms"])
                         * rec["launches_per_bfs"]
                         if rec["bfs_ms_per_launch"] is not None else None)
        per = ("not measured" if rec["bfs_ms_per_launch"] is None
               else f"{rec['bfs_ms_per_launch']:.4f}")
        gap = "not measured" if rec["gap_ms"] is None else f"{rec['gap_ms']:.3f}"
        log(f"    {rec['name']}@{rec['plane']} ({rec['cell']}, "
            f"{rec.get('activity', '-')}): {rec['launches_per_bfs']:.2f}, {per} | "
            f"{rec['ms']:.4f} | {rec['bound_ms']:.4f} ({rec['bytes'] / 1e6:.2f}) | {gap}")


def merge_launches(sync, branches, depth) -> int:
    """The ``bitmap_or_reduce`` launches one BFS must make under ``sync``,
    given each level's BRANCH from its trace and the butterfly's depth
    (rounds): a dense butterfly level merges once a round, as does every
    Rabenseifner reduce-scatter round; an xla level once (K = P); a sparse
    level never; all-to-all merges with ``|``."""
    import numpy as np

    from repro_torch.core import flightrec

    levels = len(branches)
    if sync in ("butterfly", "rabenseifner"):
        return levels * depth
    if sync == "xla":
        return levels
    if sync in ("sparse", "adaptive"):
        return int(np.sum(np.asarray(branches) != flightrec.BRANCH_SPARSE)) * depth
    return 0


def merge_cases(cell, parts, gen, dev, fanout, wave_words=None):
    """``bitmap_or_reduce`` at the shapes the other syncs give it: each
    Rabenseifner reduce-scatter round (most-significant digit first, on
    chunks of ``W/P * size`` words), the xla all-gather's P-way reduce
    (``K = P``) and, with ``wave_words``, a butterfly round of the
    multi-source wave's flat buffer.  The sparse sync's dense fallback and
    the adaptive sync's dense branch run the phase-4 ``merge`` shape."""
    from repro_torch.core import butterfly

    p, w = parts["pg"].p, parts["pg"].n_words
    cases = []

    def case(plane, path, k, width):
        stack = random_words((p, k, width), gen, dev)
        cases.append(dict(name="bitmap_or_reduce", cell=cell, plane=plane, path=path,
                          args=(stack,), kwargs={},
                          bytes=nbytes(stack) // k * (k + 1)))

    chunk, size = -(-w // p), p
    for i, rnd in enumerate(butterfly.build_schedule(p, fanout).rounds[::-1]):
        size //= rnd.digit
        case(f"rabenseifner_rs{i}", f"{cell} rabenseifner", rnd.digit, size * chunk)
    case("xla", f"{cell} xla", p, w)
    if wave_words:
        case("wave_merge", "wave butterfly", max(2, fanout), wave_words)
    return cases


class LevelBytes(list):
    """A ``level_ms`` list for ``build_bfs_fn``'s run that also keeps the
    bytes every rank has sent by the end of each level (``comm``'s count)."""

    def __init__(self, comm):
        super().__init__()
        self.comm = comm
        self.bytes = []

    def append(self, ms):
        super().append(ms)
        self.bytes.append(self.comm.bytes_sent.copy())

    def per_level(self):
        """int64[levels, P]: the bytes each rank sent in each level."""
        import numpy as np

        b = np.array(self.bytes, dtype=np.int64).reshape(len(self.bytes), -1)
        return np.diff(np.vstack([np.zeros((1, b.shape[1]), np.int64), b]), axis=0)


def level_bytes_check(label, trace, per_level, p, levels):
    """Every rank's bytes at every level (``per_level``, a LevelBytes)
    equal to the trace's byte model (over the axes' sizes where the trace
    has them); the levels the run's. Returns the bytes a rank."""
    import numpy as np

    model = trace.level_bytes_per_node().astype(np.int64)
    if trace.levels != levels or not np.array_equal(per_level.per_level(),
                                                    np.repeat(model[:, None], p, 1)):
        raise AssertionError(f"{label}: bytes per level differ from the byte model "
                             f"({trace.levels} traced levels, {levels} run)")
    return int(model.sum())


def decision_ms(buf, reps=200) -> float:
    """Host ms of one adaptive decision on ``buf[P, W]``: the two counts on
    the device and their read, as ``butterfly_or_adaptive`` makes it."""
    import torch

    from repro_torch.core import collectives

    def once():
        pops, nz = collectives.adaptive_counts(buf)
        torch.stack([pops, nz.to(pops.dtype)]).tolist()

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t0) * 1e3 / reps


def level_table_lines(trace, head=8, tail=3):
    """The flight log, one line per level (the first ``head`` and last
    ``tail`` of a long one)."""
    names = {0: "dense", 1: "sparse", 2: "fallback"}
    rows = trace.level_table()
    keep = rows if len(rows) <= head + tail else rows[:head] + [None] + rows[-tail:]
    return ["    ..." if r is None else
            f"    L{r['level']:<5d} {names[r['branch']]:8s} {'pull' if r['dir'] else 'push'} "
            f"words {r['words']:>8d}  pop {r['pop']:>8d}  shipped {r['shipped']:>7d}  "
            f"{r['bytes_per_node']:>12,.0f} B/rank" + (f"  {r['wall_ms']:.3f} ms"
                                                    if "wall_ms" in r else "")
            for r in keep]


def run_sync_cell(label, parts, cfg, base_cfg, n_roots, seed, dev, trace_reps=2):
    """One cell under a sync other than the main path's: time ``n_roots``
    roots with the CLI's protocol and validate each; hold the first
    against the dense butterfly (``base_cfg``) bit for bit; trace it and
    hold the traced run to the untraced one (distances, levels, scanned and
    every kernel's launches), the bytes each rank sent in each level to the
    trace's byte model, and the merge launches to what the trace's
    branches call for; time it ``trace_reps`` times with the trace off and
    on, in turns.  Returns the summary and a function that runs the first
    root once (for the profiles)."""
    import numpy as np
    import torch

    from repro_torch.core import bfs, collectives, flightrec
    from repro_torch.graph import csr
    from repro_torch.kernels import build
    from repro_torch.launch import bfs_run

    g, pg, layout, arrays = parts["g"], parts["pg"], parts["layout"], parts["arrays"]
    roots = csr.largest_component_roots(
        g, n_roots, np.random.default_rng(seed), labels=parts["labels"]).tolist()
    fn = bfs.build_bfs_fn(pg, cfg, layout, device=dev)
    build.reset_launches()
    runs, trimmed_ms, trimmed_gteps = bfs_run.time_roots(fn, arrays, roots, dev)
    launches = dict(build.LAUNCHES)
    for r, (dt, levels, scanned, d_owned) in zip(roots, runs):
        validate(parts, r, d_owned)
    d0, lv0, sc0 = runs[0][3], runs[0][1], runs[0][2]
    base = bfs.build_bfs_fn(pg, base_cfg, layout, device=dev)
    d_b, lv_b, sc_b = base(arrays, roots[0])
    if not (torch.equal(d0, d_b) and lv0 == lv_b and sc0 == sc_b):
        raise AssertionError(f"{label}: root {roots[0]} differs from the dense "
                             f"butterfly: levels {lv0}/{lv_b}, scanned {sc0}/{sc_b}")

    traced = bfs.build_bfs_fn(pg, cfg, layout, device=dev, trace=True, trace_levels=lv0)
    torch.cuda.synchronize()
    build.reset_launches()
    fn(arrays, roots[0])
    torch.cuda.synchronize()
    plain_launches = dict(build.LAUNCHES)
    comm = collectives.Communicator(pg.p, dev)
    per_level = LevelBytes(comm)
    build.reset_launches()
    d_t, lv_t, sc_t, tbuf = traced(arrays, roots[0], comm, level_ms=per_level)
    traced_launches = dict(build.LAUNCHES)
    if not (torch.equal(d_t, d0) and (lv_t, sc_t) == (lv0, sc0)):
        raise AssertionError(f"{label}: the traced run differs from the untraced one")
    if traced_launches != plain_launches:
        raise AssertionError(f"{label}: traced launches {traced_launches} != "
                             f"untraced {plain_launches}")
    trace = flightrec.TraversalTrace.from_buffer(
        tbuf, algo="bfs", sync=cfg.sync, p=pg.p, fanout=cfg.fanout, n_words=pg.n_words,
        capacity=cfg.resolved_capacity(pg.n_words), density_threshold=cfg.density_threshold,
        wall_ms=list(per_level))
    if trace.levels != lv0:
        raise AssertionError(f"{label}: {trace.levels} trace rows for {lv0} levels")
    sent = per_level.per_level()
    model = trace.level_bytes_per_node()
    if not np.array_equal(sent, np.repeat(model.astype(np.int64)[:, None], pg.p, 1)):
        bad = int(np.argmax(np.any(sent != model[:, None], axis=1)))
        raise AssertionError(f"{label}: level {bad + 1} sent {sent[bad]} B per rank, "
                             f"the byte model {model[bad]}")
    rec = flightrec.reconcile_bytes(trace, comm.bytes_sent)
    if not rec["matches"]:
        raise AssertionError(f"{label}: bytes do not reconcile: {rec}")
    depth = len(comm.schedule(cfg.fanout).rounds)
    want_merges = merge_launches(cfg.sync, trace.data[:, flightrec.COL_BRANCH], depth)
    if traced_launches.get("bitmap_or_reduce", 0) != want_merges:
        raise AssertionError(f"{label}: {traced_launches.get('bitmap_or_reduce', 0)} "
                             f"merge launches, the trace calls for {want_merges}")

    off_ms, on_ms, base_ms = [], [], []
    for _ in range(trace_reps):
        for run, out in ((lambda: fn(arrays, roots[0]), off_ms),
                         (lambda: traced(arrays, roots[0]), on_ms),
                         (lambda: base(arrays, roots[0]), base_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    summ = trace.summary()
    n_runs = len(roots) + 1
    summary = dict(
        sync=cfg.sync, mode=cfg.mode, roots=len(roots), ms=[x[0] * 1e3 for x in runs],
        levels=[x[1] for x in runs], scanned=[x[2] for x in runs],
        trimmed_ms=trimmed_ms, trimmed_gteps=trimmed_gteps,
        launches_per_bfs={k: v / n_runs for k, v in launches.items()},
        traced_launches=traced_launches, bytes_per_rank=int(comm.bytes_sent[0]),
        dense_bytes_per_level=rec["model"]["dense"],
        sparse_bytes_per_level=rec["model"]["sparse"],
        trace=summ, trace_off_ms=off_ms, trace_on_ms=on_ms, base_ms=base_ms,
        level_table=trace.level_table() if trace.levels <= 64 else None)
    log(f"  {label}: {len(roots)} roots valid; trimmed mean {trimmed_ms:.3f} ms, "
        f"{trimmed_gteps:.4f} GTEP/s; root {roots[0]} == dense butterfly ({lv0} levels, "
        f"{sc0:.0f} edges); traced == untraced (launches {traced_launches}); bytes == "
        f"model at every level ({summary['bytes_per_rank']:,} B per rank; dense "
        f"{rec['model']['dense']:,.0f}, sparse {rec['model']['sparse']:,.0f} per level); "
        f"merges {want_merges} as the trace calls for")
    log(f"  {label} trace: {summ['dense_levels']} dense / {summ['sparse_levels']} sparse "
        f"/ {summ['fallback_levels']} fallback levels; root {roots[0]} in turns, wall ms: "
        f"trace off {', '.join(f'{x:.3f}' for x in off_ms)}, on "
        f"{', '.join(f'{x:.3f}' for x in on_ms)}, the dense butterfly "
        f"{', '.join(f'{x:.3f}' for x in base_ms)}")
    for line in level_table_lines(trace):
        log(line)
    return summary, lambda: fn(arrays, roots[0]), lambda: base(arrays, roots[0])


def run_wave(label, parts, cfg, n_lanes, seed, dev, single):
    """One multi-source BFS wave of ``n_lanes`` largest-component roots
    (after a warm-up wave), every lane held against ``single``, the
    single-source port, at its root: lane 0 as assembled global distances,
    the others as per-rank distances on the card.  Returns the summary and a function
    that runs the wave once (for the profiles)."""
    import numpy as np
    import torch

    from repro_torch.analytics import msbfs
    from repro_torch.core import bfs
    from repro_torch.graph import csr
    from repro_torch.kernels import build

    g, pg, arrays = parts["g"], parts["pg"], parts["arrays"]
    roots = csr.largest_component_roots(
        g, n_lanes, np.random.default_rng(seed + 1), labels=parts["labels"])
    fn = msbfs.build_msbfs_fn(pg, cfg, n_lanes, device=dev)
    fn(arrays, roots)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    d_owned, levels, scanned = fn(arrays, roots)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if cfg.sync == "butterfly" and launches.get("bitmap_or_reduce", 0) == 0:
        raise AssertionError(f"{label}: the wave never launched bitmap_or_reduce")
    for b, r in enumerate(roots):
        want = single(arrays, int(r))[0]
        same = (np.array_equal(msbfs.assemble_distances(pg, d_owned, n_lanes)[b],
                               bfs.assemble_distances(pg, want)) if b == 0
                else torch.equal(d_owned[..., b], want))
        if not same:
            raise AssertionError(f"{label}: lane {b} (root {r}) differs from the "
                                 f"single-source BFS")
    summary = dict(sync=cfg.sync, mode=cfg.mode, lanes=n_lanes, ms=dt * 1e3,
                   levels=levels, scanned=scanned, gteps=scanned / dt / 1e9,
                   launches=launches, peak_bytes=peak, resident_bytes=before)
    log(f"  {label}: {n_lanes} lanes == single-source at their roots; {levels} levels, "
        f"{dt * 1e3:.3f} ms, {scanned:.0f} edges examined, {summary['gteps']:.4f} "
        f"GTEP/s aggregate; launches {launches}; peak device memory "
        f"{peak / 1e9:.2f} GB ({before / 1e9:.2f} GB resident before the wave)")
    return summary, lambda: fn(arrays, roots)


def merge_profile(label, run, top_n=5):
    """Device time of ``bitmap_or_reduce`` inside one ``run()`` (profiler),
    beside the wrapper's launch count; the device's busy time and its
    ``top_n`` kernels.  Where the
    profiler saw fewer launches than the wrapper counted (it can drop a
    record) the in-run time is None ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = build.LAUNCHES.get("bitmap_or_reduce", 0)
    cuda = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and not e.is_user_annotation]
    merge = [e for e in cuda if any(k in e.key for k in DEVICE_NAMES["bitmap_or_reduce"])]
    seen = sum(e.count for e in merge)
    ms = sum(e.self_device_time_total for e in merge) / 1e3
    busy = sum(e.self_device_time_total for e in cuda) / 1e3
    per = ms / seen if seen and seen == launches else None
    kernels = sum(e.count for e in cuda)
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in
           sorted(cuda, key=lambda e: -e.self_device_time_total)[:top_n]]
    spent_s = time.perf_counter() - t0
    log(f"  {label}: bitmap_or_reduce {launches} launches, profiler saw {seen}, "
        f"{ms:.3f} ms ({'not measured' if per is None else f'{per:.4f} ms a launch'}); "
        f"device busy {busy:.3f} ms of {wall:.3f} ms profiled wall in {kernels} device "
        f"operations ({spent_s:.1f} s with the trace's processing); by kernel:")
    for name, t, n in top:
        log(f"    {t:9.3f} ms  {n:6d}x  {name}")
    return dict(launches=launches, seen=seen, ms=ms, ms_per_launch=per, busy_ms=busy,
                profiled_wall_ms=wall, device_ops=kernels, top=top, spent_s=spent_s)


def merge_site_table(rows, paths):
    """Fill each ``merge_cases`` row with its launches per BFS (or wave) on
    its path, the in-path ms per launch (the path's profile; both
    Rabenseifner rounds share one mean) and (that - bound) x launches; log."""
    log("  bitmap_or_reduce@site (path): launches per run, ms per launch in the run | "
        "isolated ms | bound ms (MB) | gap ms per run")
    for rec in rows:
        path = paths[rec["path"]]
        prof = path.get("profile") or {}
        rec["launches_per_bfs"] = path["merge_launches_per_run"] / path.get(
            "sites_sharing", 1)
        rec["bfs_ms_per_launch"] = prof.get("ms_per_launch")
        rec["gap_ms"] = (None if rec["bfs_ms_per_launch"] is None else
                         (rec["bfs_ms_per_launch"] - rec["bound_ms"]) * rec["launches_per_bfs"])
        per = ("not measured" if rec["bfs_ms_per_launch"] is None
               else f"{rec['bfs_ms_per_launch']:.4f}")
        gap = "not measured" if rec["gap_ms"] is None else f"{rec['gap_ms']:.3f}"
        log(f"    @{rec['plane']} ({rec['path']}): {rec['launches_per_bfs']:.2f}, {per} | "
            f"{rec['ms']:.4f} | {rec['bound_ms']:.4f} ({rec['bytes'] / 1e6:.2f}) | {gap}")


# ---------------------------------------------------------------------------
# The hierarchical mesh (phase 10b)
# ---------------------------------------------------------------------------

#: Phase 10b's mesh: the P ranks as pods of 4 (pod 4 x data 4 at P = 16).
AXES_NAMES = ("pod", "data")
AXES_POD_SIZE = 4


def axes_mesh(p):
    from repro_torch.dist.sharding import SimMesh

    return SimMesh((p // AXES_POD_SIZE, AXES_POD_SIZE), AXES_NAMES)


def run_axes_bfs(parts, fanout, seed, dev, gen):
    """Phase 10b: Kronecker BFS from one largest-component root (phase 7's
    first), direction-optimizing, through the kernels, on the (pod, data)
    mesh with ``axes=("pod", "data")`` under all six syncs at ``fanout``
    and the butterfly at fanout 2.  Each run against the one-axis P-rank run
    of the same root and sync: distances, levels and edges examined bit
    for bit, the same kernel launches; each mesh run traced, every rank's
    bytes equal to the byte model over the axes' sizes at every level
    (all-to-all ships ``sum(a - 1)`` buffers a level); wall ms of each,
    in turns.  ``bitmap_or_reduce`` at the fanout-2 butterfly's
    ``[P, 2, W]`` merge, exact and timed.  Returns ``(summary, the
    launches of the mesh runs, the fanout-2 path's summary and a function
    that runs it once, the merge row)``."""
    import numpy as np
    import torch

    from repro_torch.core import bfs, collectives, flightrec
    from repro_torch.graph import csr
    from repro_torch.kernels import build

    g, pg, layout, arrays = parts["g"], parts["pg"], parts["layout"], parts["arrays"]
    mesh = axes_mesh(pg.p)
    root = csr.largest_component_roots(g, 1, np.random.default_rng(seed),
                                       labels=parts["labels"]).tolist()[0]
    out, total, f2 = {}, {}, None
    for sync, fo in [(s, fanout) for s in bfs.SYNCS] + [("butterfly", 2)]:
        label = f"axes {sync} fanout {fo}"
        one_cfg = bfs.BFSConfig(fanout=fo, sync=sync, mode="direction_optimizing",
                                use_kernels=True)
        cfg = dataclasses.replace(one_cfg, axes=mesh.axis_names)
        one = bfs.build_bfs_fn(pg, one_cfg, layout, device=dev)
        hier = bfs.build_bfs_fn(pg, cfg, layout, device=dev, mesh=mesh)
        c1, cm = collectives.Communicator(pg.p, dev), collectives.Communicator(mesh, dev)
        (d1, lv1, sc1), _, l1, _ = timed_run(one, arrays, root, c1)
        (dm, lvm, scm), _, lm, _ = timed_run(hier, arrays, root, cm)
        if not (torch.equal(d1, dm) and (lv1, sc1) == (lvm, scm)):
            raise AssertionError(f"{label}: root {root} differs from the one-axis run: "
                                 f"levels {lvm}/{lv1}, scanned {scm}/{sc1}")
        if lm != l1:
            raise AssertionError(f"{label}: launches {lm} != the one-axis run's {l1}")
        for k, v in lm.items():
            total[k] = total.get(k, 0) + v
        traced = bfs.build_bfs_fn(pg, cfg, layout, device=dev, trace=True,
                                  trace_levels=lvm, mesh=mesh)
        ct = collectives.Communicator(mesh, dev)
        per_level = LevelBytes(ct)
        d_t, lv_t, sc_t, tbuf = traced(arrays, root, ct, level_ms=per_level)
        if not (torch.equal(d_t, dm) and (lv_t, sc_t) == (lvm, scm)):
            raise AssertionError(f"{label}: the traced run differs from the untraced one")
        trace = flightrec.TraversalTrace.from_buffer(
            tbuf, algo="bfs", sync=sync, p=pg.p, fanout=fo, n_words=pg.n_words,
            capacity=cfg.resolved_capacity(pg.n_words),
            density_threshold=cfg.density_threshold, axis_sizes=mesh.sizes)
        level_bytes_check(label, trace, per_level, pg.p, lvm)
        if not np.array_equal(ct.bytes_sent, cm.bytes_sent):
            raise AssertionError(f"{label}: the traced run sent other bytes")
        ms = {"one": [], "mesh": []}
        for _ in range(2):
            for key, fn in (("one", one), ("mesh", hier)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(arrays, root)
                torch.cuda.synchronize()
                ms[key].append((time.perf_counter() - t0) * 1e3)
        summ = trace.summary()
        out[label] = dict(
            sync=sync, fanout=fo, root=root, levels=lvm, scanned=scm,
            bytes_per_rank=int(cm.bytes_sent[0]), one_axis_bytes_per_rank=int(c1.bytes_sent[0]),
            dense_bytes_per_level=trace._dense_bytes_per_node(),
            levels_dense_sparse_fallback=(summ["dense_levels"], summ["sparse_levels"],
                                          summ["fallback_levels"]),
            launches=lm, ms=ms["mesh"], one_axis_ms=ms["one"])
        log(f"  {label}: root {root} == one-axis P={pg.p} ({lvm} levels, {scm:.0f} edges, "
            f"launches {lm}); {summ['dense_levels']} dense / {summ['sparse_levels']} sparse "
            f"/ {summ['fallback_levels']} fallback levels; bytes a rank {cm.bytes_sent[0]:,} "
            f"== model at every level (one axis {c1.bytes_sent[0]:,}); wall ms mesh "
            f"{', '.join(f'{x:.3f}' for x in ms['mesh'])} | one axis "
            f"{', '.join(f'{x:.3f}' for x in ms['one'])}")
        if fo == 2:
            f2 = (out[label], lambda fn=hier: fn(arrays, root))
    if total.get("bitmap_or_reduce", 0) == 0:
        raise AssertionError(f"phase 10b: bitmap_or_reduce never launched: {total}")
    log(f"  phase 10b's mesh runs launched {total}")
    stack = random_words((pg.p, 2, pg.n_words), gen, dev)
    merge = check_kernel(dict(name="bitmap_or_reduce", cell="kronecker",
                              plane="axes_merge_f2", path="axes butterfly fanout 2",
                              args=(stack,), kwargs={}, bytes=nbytes(stack) // 2 * 3))
    return out, total, f2, merge


def run_axes_weighted(parts, fanout, dev, sssp_rows, slice5):
    """Phase 10b, continued after phase 15: SSSP (adaptive) from phase 12's
    first root and CC (adaptive) on the (pod, data) mesh with ``axes=("pod",
    "data")``: the distances equal phase 12's bit for bit, the labels
    phase 15's (the host components), with phase 12's and 15's iterations;
    SSSP traced, every rank's bytes equal to the byte model over the axes'
    sizes at every iteration; ms beside the one-axis runs'."""
    import numpy as np
    import torch

    from repro_torch import programs
    from repro_torch.core import collectives, flightrec
    from repro_torch.traversal import sssp

    pg, arrays = parts["pg"], parts["arrays"]
    mesh = axes_mesh(pg.p)
    out = {}
    root = next(iter(sssp_rows))
    cfg = sssp.SSSPConfig(axes=mesh.axis_names, fanout=fanout, sync="adaptive")
    fn = sssp.build_sssp_fn(pg, cfg, device=dev, mesh=mesh)
    fn(arrays, root)
    comm = collectives.Communicator(mesh, dev)
    (d, iters, relaxed), ms, launches, peak = timed_run(fn, arrays, root, comm)
    one = slice5["sssp adaptive"]
    if not torch.equal(d, sssp_rows[root]) or iters != one["iters"][0]:
        raise AssertionError(f"axes sssp: root {root} differs from phase 12 "
                             f"({iters} / {one['iters'][0]} iterations)")
    n_rows = sssp.dist_rows(pg)
    ct = collectives.Communicator(mesh, dev)
    per_level = LevelBytes(ct)
    traced = sssp.build_sssp_fn(pg, cfg, device=dev, trace=True, trace_levels=iters,
                                mesh=mesh)
    d_t, it_t, _, tbuf = traced(arrays, root, ct, level_ms=per_level)
    trace = flightrec.TraversalTrace.from_buffer(
        tbuf, algo="sssp", sync="adaptive", p=pg.p, fanout=fanout, n_words=n_rows,
        capacity=cfg.resolved_capacity(n_rows), density_threshold=cfg.density_threshold,
        axis_sizes=mesh.sizes)
    if not torch.equal(d_t, d):
        raise AssertionError("axes sssp: the traced run differs from the untraced one")
    level_bytes_check("axes sssp", trace, per_level, pg.p, iters)
    out["sssp adaptive"] = dict(root=root, iters=iters, relaxed=relaxed, ms=ms,
                                one_axis_ms=one["ms"][0], bytes_per_rank=int(comm.bytes_sent[0]),
                                one_axis_bytes_per_rank=one["bytes_per_rank"],
                                launches=launches, peak_bytes=peak)
    log(f"  axes sssp adaptive: root {root} == phase 12 ({iters} iterations, {relaxed:.0f} "
        f"relaxations); bytes a rank {comm.bytes_sent[0]:,} == model at every iteration; "
        f"{ms:.3f} ms (phase 12's first root {one['ms'][0]:.3f} ms)")

    prog = programs.by_name("cc")
    pcfg = programs.ProgramConfig(axes=mesh.axis_names, fanout=fanout, sync="adaptive")
    fn = programs.build_program_fn(pg, prog, pcfg, device=dev, mesh=mesh)
    arg = prog.default_arg(pg, dev)
    fn(arrays, arg)
    comm = collectives.Communicator(mesh, dev)
    res, ms, launches, peak = timed_run(fn, arrays, arg, comm)
    one = slice5["cc adaptive"]
    if not np.array_equal(prog.assemble(pg, res[0]), min_id_labels(parts["labels"])) \
            or res[-2] != one["iters"]:
        raise AssertionError(f"axes cc: labels or rounds ({res[-2]} / {one['iters']}) "
                             f"differ from phase 15")
    out["cc adaptive"] = dict(iters=res[-2], work=res[-1], ms=ms, one_axis_ms=one["ms"],
                              bytes_per_rank=int(comm.bytes_sent[0]),
                              one_axis_bytes_per_rank=one["bytes_per_rank"],
                              launches=launches, peak_bytes=peak)
    log(f"  axes cc adaptive: labels == phase 15 (host components), {res[-2]} rounds; "
        f"bytes a rank {comm.bytes_sent[0]:,} (one axis {one['bytes_per_rank']:,}); "
        f"{ms:.3f} ms (phase 15 {one['ms']:.3f} ms)")
    return out


def run_tools(parts, scale, edge_factor):
    """Phase 10b's analysis tools, host calls: ``synthetic_shapes`` of the
    Kronecker graph beside its real partition, ``step_bytes`` and
    ``prefill_corrections`` of the LM config."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.graph import partition
    from repro_torch.launch import analytic, corrections

    pg = parts["pg"]
    syn = partition.synthetic_shapes(1 << scale, 2 * (1 << scale) * edge_factor, pg.p)
    real = dict(emax=pg.emax, vmax=pg.vmax, n_words=pg.n_words)
    planned = dict(emax=syn.emax, vmax=syn.vmax, n_words=syn.n_words)
    bounds = all(planned[k] >= real[k] for k in real)
    cfg = configs.get_config(LM_ARCH)
    step = analytic.step_bytes(cfg, SHAPES["train_4k"])
    corr = corrections.prefill_corrections(cfg, SHAPES["prefill_32k"])
    log(f"  synthetic_shapes(2^{scale}, {2 * (1 << scale) * edge_factor:,}, {pg.p}): "
        f"{planned} against the partition's {real} (upper bound: {bounds})")
    log(f"  step_bytes({LM_ARCH}, train_4k): {step['global']:,.0f} B a step "
        f"(params {step['detail']['params']:,.0f}, active {step['detail']['active']:,.0f}); "
        f"prefill_corrections(prefill_32k): {corr['flops']:,.0f} flops, "
        f"{corr['bytes']:,.0f} B (a scan-body count's; the port's count needs none)")
    return dict(synthetic=planned, partition=real, upper_bound=bounds,
                step_bytes_train_4k=step, prefill_corrections_32k=corr)


# ---------------------------------------------------------------------------
# The weighted traversals and the vertex programs (phases 12-17)
# ---------------------------------------------------------------------------


def sssp_dist(d_owned, slot):
    """Per-rank owned distances ``int32[P, vmax]`` (uint32 patterns) ->
    int64[n] by vertex, ``UNREACHED`` (0xFFFFFFFF) for unreached."""
    return d_owned.reshape(-1)[slot].long() & 0xFFFFFFFF


def sssp_certificate(src, dst, w, dist, root) -> None:
    """Graph500's SSSP checks of ``dist`` (int64[n], UNREACHED unreached)
    over the edges ``(src, dst, w)`` of a symmetric graph, on the device
    that holds them: ``d[root] = 0``; ``d[v] <= d[u] + w`` on every edge
    from a reached ``u``; every reached ``v != root`` has an in-edge with
    ``d[v] = d[u] + w``; no reached vertex neighbours an unreached one."""
    import torch

    unreached = 0xFFFFFFFF
    if int(dist[root]) != 0:
        raise AssertionError(f"root {root}: d[root] = {int(dist[root])}")
    reached = dist != unreached
    from_reached = reached[src]
    if bool((from_reached & ~reached[dst]).any()):
        raise AssertionError(f"root {root}: a reached vertex neighbours an unreached one")
    du, dv = dist[src], dist[dst]
    if bool((from_reached & (dv > du + w)).any()):
        raise AssertionError(f"root {root}: an edge relaxes a distance further")
    tight = torch.zeros(dist.numel(), dtype=torch.uint8, device=dist.device)
    tight.scatter_reduce_(0, dst, (from_reached & (dv == du + w)).to(torch.uint8), "amax")
    orphan = reached & (tight == 0)
    orphan[root] = False
    if bool(orphan.any()):
        raise AssertionError(f"root {root}: {int(orphan.sum())} reached vertices have "
                             f"no in-edge on a shortest path")


def brandes_identity(delta, levels, rtol=1e-4):
    """One lane's ``sum_v delta_s(v)`` against ``sum_{t reached, t != s}
    (d(s, t) - 1)``: every shortest s-t path has d - 1 interior vertices,
    and each counts its share of the s-t paths once.  ``delta`` and
    ``levels`` are the lane's owned rows (0 and INF where unreached or not
    owned).  Returns both sums; raises where they differ by more than
    ``rtol``."""
    from repro_torch.core.bfs import INF

    lv = levels.long()
    want = float((lv[(lv < INF) & (lv > 0)] - 1).sum())
    got = float(delta.double().sum())
    if abs(got - want) > rtol * max(want, 1.0):
        raise AssertionError(f"Brandes' identity: sum of dependencies {got} != "
                             f"sum of (d - 1) {want}")
    return got, want


def hindex_violations(src, dst, core) -> int:
    """Vertices whose core number is not the h-index of their neighbours'
    core numbers (the fixed point of k-core decomposition): ``core(v) = c``
    is that h-index iff at least ``c`` neighbours have core ``>= c`` and at
    most ``c`` have core ``>= c + 1``."""
    import torch

    c, cu = core[src], core[dst]
    at_least = torch.zeros_like(core).scatter_add_(0, src, (cu >= c).to(core.dtype))
    above = torch.zeros_like(core).scatter_add_(0, src, (cu >= c + 1).to(core.dtype))
    return int(((at_least < core) | (above > core)).sum())


def pagerank_residual(src, dst, n: int, rank, damping: float) -> float:
    """L1 distance, in float64, between ``rank[n]`` and one more power step
    of the reference's iteration (per-edge ``rank[u] / deg_out[u]`` pushes,
    dangling mass spread uniformly)."""
    import torch

    rank = rank.double()
    deg = torch.bincount(src, minlength=n).double()
    contrib = torch.zeros(n, dtype=torch.float64, device=rank.device)
    contrib.index_add_(0, dst, rank[src] / deg[src])
    dangle = rank[deg == 0].sum()
    new = (1.0 - damping) / n + damping * (contrib + dangle / n)
    return float((new - rank).abs().sum())


def min_id_labels(labels):
    """``csr.connected_components`` labels -> each vertex's component
    minimum vertex id (the fixed point of min-label propagation)."""
    import numpy as np

    return np.unique(labels, return_index=True)[1][labels]


def slice_merge_cases(gen, dev, p, fanout, words_by_plane):
    """``bitmap_or_reduce`` at the butterfly shapes ``[P, digit, W]`` of
    this slice's OR merges, ``W`` per plane: the BC wave buffer, the
    k-core peel bitmap and the triangle adjacency."""
    from repro_torch.core import butterfly

    k = butterfly.build_schedule(p, fanout).rounds[0].digit
    cases = []
    for plane, (path, words) in words_by_plane.items():
        stack = random_words((p, k, words), gen, dev)
        cases.append(dict(name="bitmap_or_reduce", cell=path, plane=plane, path=path,
                          args=(stack,), kwargs={}, bytes=nbytes(stack) // k * (k + 1)))
    return cases


def timed_run(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once with the launch counts set to 0 just
    before and the peak memory reset: ``(out, ms, launches, peak bytes)``,
    the clock stopping after the device synchronises."""
    import torch

    from repro_torch.kernels import build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, dict(build.LAUNCHES), torch.cuda.max_memory_allocated()


def run_sssp(parts, fanout, seed, dev, syncs, delta, keep=None):
    """Phase 12: SSSP on the weighted Kronecker graph under each sync of
    ``syncs`` (sync -> roots) and the butterfly with ``delta`` buckets at
    the first root; every root passes the certificate on the card, the
    first root equals the butterfly's distances bit for bit under every
    sync, and, traced, sends at every iteration the bytes the trace's model
    gives each rank.  A dict ``keep`` receives the butterfly's per-rank
    distances by root (for the engine's check)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives, flightrec
    from repro_torch.graph import csr
    from repro_torch.launch import bfs_run
    from repro_torch.traversal import sssp

    g, pg, arrays = parts["g"], parts["pg"], parts["arrays"]
    src, dst, _, slot = parts["check"]
    w = parts["weights"]
    roots = csr.largest_component_roots(g, max(syncs.values()), np.random.default_rng(
        seed + 2), labels=parts["labels"]).tolist()
    n_rows = sssp.dist_rows(pg)
    out, base = {}, None
    cells = [(s, 0, n) for s, n in syncs.items()] + [("butterfly", delta, 1)]
    for sync, dlt, n in cells:
        label = f"sssp {sync}" + (f" delta {dlt}" if dlt else "")
        cfg = sssp.SSSPConfig(fanout=fanout, sync=sync, delta=dlt)
        fn = sssp.build_sssp_fn(pg, cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        runs, trimmed_ms, _ = bfs_run.time_roots(fn, arrays, roots[:n], dev)
        peak = torch.cuda.max_memory_allocated()
        for r, (_, iters, relaxed, d_owned) in zip(roots, runs):
            sssp_certificate(src, dst, w, sssp_dist(d_owned, slot), r)
        if base is None:
            base = runs[0][3]
            if keep is not None:
                keep.update({r: x[3] for r, x in zip(roots, runs)})
        elif not torch.equal(runs[0][3], base):
            raise AssertionError(f"{label}: root {roots[0]} differs from the butterfly")
        # the first root traced: the bytes of every iteration against the model
        comm = collectives.Communicator(pg.p, dev)
        per_level = LevelBytes(comm)
        traced = sssp.build_sssp_fn(pg, cfg, device=dev, trace=True,
                                    trace_levels=runs[0][1])
        d_t, it_t, _, tbuf = traced(arrays, roots[0], comm, level_ms=per_level)
        if not torch.equal(d_t, runs[0][3]) or it_t != runs[0][1]:
            raise AssertionError(f"{label}: the traced run differs from the untraced one")
        trace = flightrec.TraversalTrace.from_buffer(
            tbuf, algo="sssp", sync=sync, p=pg.p, fanout=fanout, n_words=n_rows,
            capacity=cfg.resolved_capacity(n_rows), density_threshold=cfg.density_threshold)
        level_bytes_check(label, trace, per_level, pg.p, it_t)
        ms = [x[0] * 1e3 for x in runs]
        relaxed = [x[2] for x in runs]
        summ = trace.summary()
        out[label] = dict(
            sync=sync, delta=dlt, roots=len(runs), ms=ms, trimmed_ms=trimmed_ms,
            iters=[x[1] for x in runs], relaxed=relaxed,
            grelax_per_s=[r / t / 1e6 for r, t in zip(relaxed, ms)],
            bytes_per_rank=int(comm.bytes_sent[0]), peak_bytes=peak,
            levels_dense_sparse_fallback=(summ["dense_levels"], summ["sparse_levels"],
                                          summ["fallback_levels"]))
        log(f"  {label}: {len(runs)} roots pass the certificate"
            f"{'' if label == 'sssp butterfly' else ', root ' + str(roots[0]) + ' == butterfly'}"
            f"; trimmed mean {trimmed_ms:.3f} ms, iterations {out[label]['iters']}, "
            f"{np.mean(out[label]['grelax_per_s']):.4f} G relaxations/s; traced root "
            f"{summ['dense_levels']} dense / {summ['sparse_levels']} sparse / "
            f"{summ['fallback_levels']} fallback, {out[label]['bytes_per_rank']:,} B per "
            f"rank == model at every iteration; peak {peak / 1e9:.2f} GB")
    return out


def run_bc(parts, fanout, seed, dev, single, n_lanes, small):
    """Phase 13: one ``n_lanes``-lane Brandes wave, top-down, butterfly, on
    the Kronecker graph: each lane's levels equal the single-source port's
    BFS at its root, each lane's dependencies satisfy Brandes' identity;
    then ``small`` (a small graph's parts) against host Brandes over 8
    sources.  Returns the summary and a function that runs the wave."""
    import numpy as np
    import torch

    from repro_torch.core import bfs, collectives
    from repro_torch.graph import csr
    from repro_torch.traversal import bc

    g, pg, arrays = parts["g"], parts["pg"], parts["arrays"]
    cfg = bfs.BFSConfig(fanout=fanout, sync="butterfly", mode="top_down")
    roots = csr.largest_component_roots(g, n_lanes, np.random.default_rng(seed + 3),
                                        labels=parts["labels"]).tolist()
    fn = bc.build_bc_fn(pg, cfg, n_lanes, device=dev)
    fn(arrays, roots)
    comm = collectives.Communicator(pg.p, dev)
    lanes = {}
    (bc_owned, depth, scanned), ms, launches, peak = timed_run(fn, arrays, roots, comm,
                                                               lanes=lanes)
    if launches.get("bitmap_or_reduce", 0) == 0:
        raise AssertionError("bc: the wave never launched bitmap_or_reduce")
    sums = []
    for b, r in enumerate(roots):
        if not torch.equal(lanes["levels"][..., b], single(arrays, r)[0]):
            raise AssertionError(f"bc: lane {b} (root {r}) levels differ from the BFS")
        sums.append(brandes_identity(lanes["delta"][..., b], lanes["levels"][..., b]))
    del lanes
    # a small graph against host Brandes
    sources = csr.largest_component_roots(small["g"], 8, np.random.default_rng(seed),
                                          labels=small["labels"])
    got, _, _ = bc.betweenness_centrality(small["pg"], sources, cfg, device=dev)
    want = bc.bc_reference(small["g"], sources)
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"bc: scale-{small['scale']} scores differ from host Brandes "
                             f"(max abs err {np.abs(got - want).max()})")
    summary = dict(lanes=n_lanes, roots=roots, ms=ms, depth=depth, scanned=scanned,
                   gteps=scanned / ms / 1e6, bytes_per_rank=int(comm.bytes_sent[0]),
                   launches=launches, peak_bytes=peak, identity=sums,
                   small_max_abs_err=float(np.abs(got - want).max()))
    log(f"  bc: {n_lanes} lanes' levels == the BFS at their roots, Brandes' identity "
        f"holds per lane ({', '.join(f'{a:.6g}/{b:.6g}' for a, b in sums)}); {depth} levels, "
        f"{ms:.3f} ms, {scanned:.0f} edges examined, {summary['gteps']:.4f} GTEP/s; "
        f"{summary['bytes_per_rank']:,} B per rank; launches {launches}; peak "
        f"{peak / 1e9:.2f} GB; scale {small['scale']}, 8 sources == host Brandes (max abs "
        f"err {summary['small_max_abs_err']:.3g})")
    return summary, lambda: fn(arrays, roots)


def run_program_path(label, parts, prog, cfg, dev, warmup=True):
    """One vertex program on ``parts``, after a warm-up run where
    ``warmup``: ``(summary, result, output)``; the summary has the time,
    rounds, edges examined and their rate, bytes a rank, launches and peak
    memory."""
    from repro_torch import programs
    from repro_torch.core import collectives

    fn = programs.build_program_fn(parts["pg"], prog, cfg, device=dev)
    arg = prog.default_arg(parts["pg"], dev)
    if warmup:
        fn(parts["arrays"], arg)
    comm = collectives.Communicator(parts["pg"].p, dev)
    out, ms, launches, peak = timed_run(fn, parts["arrays"], arg, comm)
    iters, work = out[-2], out[-1]
    summary = dict(sync=cfg.sync, ms=ms, iters=iters, work=work,
                   gedges_per_s=work / ms / 1e6, bytes_per_rank=int(comm.bytes_sent[0]),
                   launches=launches, peak_bytes=peak)
    log(f"  {label}: {iters} rounds, {ms:.3f} ms, {work:.0f} edges examined, "
        f"{summary['gedges_per_s']:.4f} G edges/s; {summary['bytes_per_rank']:,} B per "
        f"rank; launches {launches}; peak {peak / 1e9:.2f} GB")
    return summary, prog.assemble(parts["pg"], out[0]), out


def run_pagerank(parts, fanout, dev, tol=1e-5, keep=None):
    """Phase 14: PageRank under the butterfly and the sparse (delta) sync,
    both with PyTorch's deterministic algorithms on (the per-rank
    contribution sum is a ``scatter_add_``, whose CUDA atomics add in an
    order that changes from run to run): the L1 residual of one more power
    step within the reference's ``2 tol d / (1 - d)``, and the sparse
    wire's ranks equal to the dense ones bit for bit.  A dict ``keep``
    receives the butterfly's global ranks (for the service's check)."""
    import torch

    from repro_torch import programs

    prog = programs.by_name("pagerank")
    src, dst = parts["check"][:2]
    bound = 2 * tol * 0.85 / 0.15
    out, ranks = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for sync in ("butterfly", "sparse"):
            cfg = programs.ProgramConfig(fanout=fanout, sync=sync, tol=tol)
            label = f"pagerank {sync}"
            out[label], res, raw = run_program_path(label, parts, prog, cfg, dev)
            ranks[sync] = raw[0]
            if keep is not None and sync == "butterfly":
                keep["pagerank"] = res
            resid = pagerank_residual(src, dst, parts["pg"].n,
                                      torch.as_tensor(res, device=dev), cfg.damping)
            if not resid <= bound:
                raise AssertionError(f"{label}: L1 residual {resid} > {bound}")
            out[label]["residual"] = resid
            log(f"  {label}: L1 residual of one more step {resid:.3e} <= {bound:.3e}")
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(ranks["butterfly"].view(torch.int32), ranks["sparse"].view(torch.int32)):
        raise AssertionError("pagerank: the sparse wire's ranks differ from the dense ones")
    log("  pagerank: sparse (delta) ranks == butterfly ranks bit for bit")
    return out


def run_cc(parts, fanout, dev):
    """Phase 15: connected components under the butterfly and adaptive
    syncs, labels equal to the host's ``csr.connected_components``."""
    import numpy as np

    from repro_torch import programs

    want = min_id_labels(parts["labels"])
    out = {}
    for sync in ("butterfly", "adaptive"):
        label = f"cc {sync}"
        out[label], res, _ = run_program_path(
            label, parts, programs.by_name("cc"),
            programs.ProgramConfig(fanout=fanout, sync=sync), dev)
        if not np.array_equal(res, want):
            raise AssertionError(f"{label}: labels differ from the host components")
    log("  cc: labels == host components under both syncs")
    return out


def run_kcore(parts, fanout, dev, small):
    """Phase 16: k-core on the Kronecker graph, the h-index fixed point
    checked for every vertex on the card; ``small`` against the host
    peeling oracle.  Returns the summary and a function that runs its first
    ``KCORE_PROFILE_ROUNDS`` rounds (the profile's run)."""
    import numpy as np
    import torch

    from repro_torch import programs

    prog = programs.by_name("kcore")
    cfg = programs.ProgramConfig(fanout=fanout)
    # thousands of rounds: the first round's set-up is lost in them
    summary, res, _ = run_program_path("kcore", parts, prog, cfg, dev, warmup=False)
    if summary["launches"].get("bitmap_or_reduce", 0) == 0:
        raise AssertionError("kcore: the peel waves never launched bitmap_or_reduce")
    src, dst = parts["check"][:2]
    bad = hindex_violations(src, dst, torch.as_tensor(res, device=dev))
    if bad:
        raise AssertionError(f"kcore: {bad} vertices off the h-index fixed point")
    got, _, _ = programs.run_program(small["pg"], prog, cfg, device=dev)
    if not np.array_equal(got, programs.kcore_reference(small["g"])):
        raise AssertionError(f"kcore: scale {small['scale']} differs from the host")
    summary["max_core"] = int(res.max())
    log(f"  kcore: h-index fixed point holds at every vertex (max core "
        f"{summary['max_core']}); scale {small['scale']} == host peeling")
    fn = programs.build_program_fn(parts["pg"], prog, dataclasses.replace(
        cfg, max_iters=KCORE_PROFILE_ROUNDS), device=dev)
    return summary, lambda: fn(parts["arrays"])


def run_triangles(parts, fanout, dev):
    """Phase 17: triangle counts against the host oracle.  Returns the
    summary and a function that runs the count."""
    import numpy as np

    from repro_torch import programs

    prog = programs.by_name("tri")
    cfg = programs.ProgramConfig(fanout=fanout)
    summary, res, _ = run_program_path("tri", parts, prog, cfg, dev)
    if summary["launches"].get("bitmap_or_reduce", 0) == 0:
        raise AssertionError("tri: the adjacency merge never launched bitmap_or_reduce")
    if not np.array_equal(res, programs.triangles_reference(parts["g"])):
        raise AssertionError("tri: per-vertex counts differ from the host")
    summary["triangles"] = programs.total_triangles(res)
    log(f"  tri: per-vertex counts == host ({summary['triangles']:,} triangles)")
    fn = programs.build_program_fn(parts["pg"], prog, cfg, device=dev)
    return summary, lambda: fn(parts["arrays"])


# ---------------------------------------------------------------------------
# Streaming mutations and the batched query engine (phases 18-22)
# ---------------------------------------------------------------------------


def rank_owners(pg, vids):
    """The rank that owns each vertex of ``vids``."""
    import numpy as np

    return np.searchsorted(pg.v_start, np.asarray(vids), side="right") - 1


def fitting_batch(overlay, pg, rng, n_insert, n_delete, max_weight):
    """A seeded batch against the overlay's current edges
    (``DeltaOverlay.sample_batch``) cut to the ranks' slack: the sampled
    undirected inserts are kept in order while both directions' slots fit
    every rank's ``emax - count`` (out and in), so the in-place patch
    accepts the batch.  Returns ``(batch, inserts kept)``."""
    import numpy as np

    from repro_torch.dynamic import delta

    b = overlay.sample_batch(rng, n_insert, n_delete, max_weight=max_weight)
    free_out = (pg.emax - pg.edge_count).astype(np.int64)
    free_in = (pg.emax - pg.in_count).astype(np.int64)
    keep = []
    for i, (u, v) in enumerate(zip(b.insert_src.tolist(), b.insert_dst.tolist())):
        if u == v:
            continue
        need = np.bincount(rank_owners(pg, [u, v]), minlength=pg.p)
        if np.all(free_out >= need) and np.all(free_in >= need):
            free_out -= need
            free_in -= need
            keep.append(i)
    w = None if b.insert_weights is None else b.insert_weights[keep]
    return delta.EdgeBatch(insert_src=b.insert_src[keep], insert_dst=b.insert_dst[keep],
                           insert_weights=w, delete_src=b.delete_src,
                           delete_dst=b.delete_dst), len(keep)


def vertex_slots(pg, dev):
    """int64[n] on ``dev``: each vertex's slot in the flat ``[P, vmax]``
    owned rows."""
    import numpy as np
    import torch

    owner = rank_owners(pg, np.arange(pg.n))
    slot = owner * pg.vmax + np.arange(pg.n) - pg.v_start[owner]
    return torch.as_tensor(slot.astype(np.int64), device=dev)


def edge_tensors(src, dst, w, dev):
    """The certificate's edge arrays (int64) on ``dev``."""
    import numpy as np
    import torch

    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
                 for a in (src, dst, w))


def certify_levels(edges, dist_row, root, dev):
    """BFS levels (int64[n], INT32_MAX unreached) held to the SSSP
    certificate with unit weights on ``edges`` (a symmetric graph): the
    Graph500 rules of a BFS tree."""
    import numpy as np
    import torch

    from repro_torch.traversal import sssp

    src, dst, _ = edges
    d = torch.as_tensor(np.where(dist_row >= np.iinfo(np.int32).max, sssp.UNREACHED,
                                 dist_row), device=dev)
    sssp_certificate(src, dst, torch.ones_like(src), d, root)


def scratch_fns(pg, fanout, dev):
    """From-scratch port traversals of ``pg`` as it stands: the plain BFS
    (direction-optimizing, butterfly; no kernel layout, which is built from
    the edge arrays and would go stale under a patch) and the butterfly
    SSSP.  Each maps ``(arrays, root)`` to the global int64 row."""
    from repro_torch.core import bfs
    from repro_torch.traversal import sssp

    bfn = bfs.build_bfs_fn(pg, bfs.BFSConfig(fanout=fanout, mode="direction_optimizing"),
                           device=dev)
    sfn = sssp.build_sssp_fn(pg, sssp.SSSPConfig(fanout=fanout), device=dev)
    return {"bfs": lambda a, r: bfs.assemble_distances(pg, bfn(a, r)[0]),
            "sssp": lambda a, r: sssp.assemble_distances(pg, sfn(a, r)[0])}


def mutation_setup(parts, fanout, seed, dev, n_roots):
    """Phase 19's state: a copy of the weighted Kronecker partition (the
    phases before keep the original), the delta overlay on its graph, an
    engine placed on the copy (its arrays are refreshed after every patch
    and the repairs read them), and cached BFS and SSSP rows of
    ``n_roots`` largest-component roots, computed from scratch."""
    import copy

    import numpy as np

    from repro_torch.analytics.engine import BFSQueryEngine
    from repro_torch.core import bfs
    from repro_torch.dynamic import delta
    from repro_torch.graph import csr

    t0 = time.perf_counter()
    pg = copy.deepcopy(parts["pg"])
    overlay = delta.DeltaOverlay(parts["g"])
    eng = BFSQueryEngine(pg, bfs.BFSConfig(fanout=fanout), lanes=LANES, device=dev)
    roots = csr.largest_component_roots(parts["g"], n_roots, np.random.default_rng(seed + 5),
                                        labels=parts["labels"]).tolist()
    scratch = scratch_fns(pg, fanout, dev)
    rows = {(kind, r): fn(eng._arrays, r) for kind, fn in scratch.items() for r in roots}
    free_out, free_in = pg.emax - pg.edge_count, pg.emax - pg.in_count
    log(f"  copy, overlay, engine and {len(rows)} cached rows in "
        f"{time.perf_counter() - t0:.1f} s; slack per rank (emax - count), out: "
        f"{free_out.tolist()}; in: {free_in.tolist()}")
    return dict(pg=pg, overlay=overlay, engine=eng, roots=roots, rows=rows,
                scratch=scratch, rng=np.random.default_rng(seed + 6), fanout=fanout,
                slack_out=free_out.tolist(), slack_in=free_in.tolist())


def repair_batch(label, mut, batch, dev):
    """Apply ``batch`` to the overlay and, in place, to the partition copy
    (the patch must accept it), refresh the engine's arrays, and repair
    every cached row: BFS levels under each of ``REPAIR_SYNCS``, SSSP
    distances under the butterfly.  Each repaired row must equal the
    from-scratch port traversal of the mutated partition bit for bit, and
    every SSSP row pass the Graph500 SSSP certificate on the overlay's
    current edges; a repair with a taint phase under the butterfly must
    launch ``bitmap_or_reduce``.  The cached rows become the repaired ones.
    Returns the summary and a function that repeats the first root's BFS
    repair under the butterfly (for the profile)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives
    from repro_torch.dynamic import delta, repair
    from repro_torch.traversal import sssp

    pg, eng = mut["pg"], mut["engine"]
    t0 = time.perf_counter()
    update = mut["overlay"].apply(batch)
    if not delta.apply_update_to_partition(pg, update):
        raise AssertionError(f"{label}: the in-place patch refused a batch cut to the slack")
    eng.refresh_arrays()
    patch_s = time.perf_counter() - t0
    edges = edge_tensors(*mut["overlay"].edge_arrays(), dev)
    out = dict(inserts=int(update.ins_src.size), deletes=int(update.del_src.size),
               patch_s=patch_s, rows={})
    r0, row0 = mut["roots"][0], mut["rows"]["bfs", mut["roots"][0]]
    cfg0 = sssp.SSSPConfig(fanout=mut["fanout"])
    rerun = lambda: repair.repair_row(pg, row0, update, cfg0,  # noqa: E731
                                      unit_weight=True, arrays=eng._arrays, device=dev)
    for r in mut["roots"]:
        for kind, syncs in (("bfs", REPAIR_SYNCS), ("sssp", ("butterfly",))):
            want, scratch_ms, _, _ = timed_run(mut["scratch"][kind], eng._arrays, r)
            for sync in syncs:
                comm = collectives.Communicator(pg.p, dev)
                cfg = sssp.SSSPConfig(fanout=mut["fanout"], sync=sync)
                (row, touched, iters), ms, launches, peak = timed_run(
                    repair.repair_row, pg, mut["rows"][kind, r], update, cfg,
                    unit_weight=kind == "bfs", arrays=eng._arrays, device=dev, comm=comm)
                if not np.array_equal(row, want):
                    raise AssertionError(f"{label}: {kind} root {r} under {sync}: the "
                                         f"repaired row differs from the from-scratch one")
                tainted = repair.repair_seeds(mut["rows"][kind, r], update,
                                              unit_weight=kind == "bfs")[1].size > 0
                if sync == "butterfly" and tainted and not launches["bitmap_or_reduce"]:
                    raise AssertionError(f"{label}: {kind} root {r}: the taint phase never "
                                         f"launched bitmap_or_reduce")
                out["rows"][f"{kind} {sync} {r}"] = dict(
                    ms=ms, scratch_ms=scratch_ms, iters=iters, touched=touched,
                    bytes_per_rank=int(comm.bytes_sent[0]), launches=launches,
                    peak_bytes=peak, tainted=tainted)
                log(f"  {label}: {kind} {sync} root {r}: repair {ms:.1f} ms, {iters} "
                    f"iterations, {touched:,} touched, {int(comm.bytes_sent[0]):,} B per "
                    f"rank, launches {launches}, peak {peak / 1e9:.2f} GB; from scratch "
                    f"{scratch_ms:.1f} ms; equal")
            if kind == "sssp":
                sssp_certificate(*edges, torch.as_tensor(want, device=dev), r)
            mut["rows"][kind, r] = want
    del edges
    out["first"] = out["rows"][f"bfs butterfly {r0}"]
    log(f"  {label}: {out['inserts']} directed inserts, {out['deletes']} deletes patched "
        f"in place in {patch_s:.1f} s; every row equal to from scratch, SSSP rows certified")
    return out, rerun


def unchanged_batch(mut, dev):
    """One insert between two vertices at the same BFS level of the first
    cached root, patched in place: the root's row is proven unchanged on
    the host (touched 0, iterations 0, the row itself returned, no kernel
    launched), and equals the from-scratch BFS."""
    import numpy as np

    from repro_torch.dynamic import delta, repair
    from repro_torch.traversal import sssp

    pg, eng, r = mut["pg"], mut["engine"], mut["roots"][0]
    row = mut["rows"]["bfs", r]
    level = np.flatnonzero(row == 2)
    for a, b in zip(level[:-1:2].tolist(), level[1::2].tolist()):
        if np.any(np.bincount(rank_owners(pg, [a, b]), minlength=pg.p)
                  > np.minimum(pg.emax - pg.edge_count, pg.emax - pg.in_count)):
            continue
        update = mut["overlay"].apply(delta.EdgeBatch.insert([a], [b], [WEIGHT]))
        if not update.empty:
            break
    else:
        raise AssertionError("no same-level pair fits the slack")
    if not delta.apply_update_to_partition(pg, update):
        raise AssertionError("the same-level insert was refused")
    eng.refresh_arrays()
    (got, touched, iters), ms, launches, _ = timed_run(
        repair.repair_row, pg, row, update, sssp.SSSPConfig(fanout=mut["fanout"]),
        unit_weight=True, arrays=eng._arrays, device=dev)
    if got is not row or touched or iters or any(launches.values()):
        raise AssertionError(f"unchanged root {r}: touched {touched}, iterations {iters}, "
                             f"launches {launches}")
    if not np.array_equal(mut["scratch"]["bfs"](eng._arrays, r), row):
        raise AssertionError(f"unchanged root {r}: the row differs from the from-scratch one")
    log(f"  unchanged: insert ({a}, {b}) at level 2 of root {r}: proven unchanged in "
        f"{ms:.3f} ms, touched 0, 0 iterations, launches {launches}; == from scratch")
    return dict(edge=(a, b), ms=ms, launches=launches)


def overflow_batch(mut, fanout, dev, ranks, fraction=OVERFLOW_FRACTION):
    """A batch of random inserts, ``fraction`` of the edges or the ranks'
    total slack if that is more: the in-place patch must refuse it with
    every partition array byte-equal to before;
    then the compaction path (``overlay.compact()``, ``partition_1d``)
    gives a partition whose fresh BFS and SSSP pass the certificates on
    the compacted graph's edges."""
    import numpy as np

    from repro_torch.core import bfs
    from repro_torch.dynamic import delta
    from repro_torch.graph import partition
    from repro_torch.traversal import sssp

    pg, overlay = mut["pg"], mut["overlay"]
    n_ins = max(int(fraction * overlay.n_edges) // 2, int((pg.emax - pg.edge_count).sum()))
    update = overlay.apply(overlay.sample_batch(mut["rng"], n_ins, 0, max_weight=WEIGHT))
    before = {k: v.copy() for k, v in pg.arrays().items()}
    t0 = time.perf_counter()
    if delta.apply_update_to_partition(pg, update):
        raise AssertionError(f"overflow: a {n_ins}-insert batch was patched in place")
    refuse_ms = (time.perf_counter() - t0) * 1e3
    changed = [k for k, v in pg.arrays().items() if not np.array_equal(v, before[k])]
    if changed:
        raise AssertionError(f"overflow: the refused patch changed {changed}")
    del before
    t = [time.perf_counter()]
    gc = overlay.compact()
    t.append(time.perf_counter())
    pc = partition.partition_1d(gc, ranks)
    t.append(time.perf_counter())
    arrays = bfs.place_arrays(pc, device=dev)
    root = mut["roots"][0]
    edges = edge_tensors(gc.src, gc.dst, gc.weights, dev)
    fn = bfs.build_bfs_fn(pc, bfs.BFSConfig(fanout=fanout, mode="direction_optimizing"),
                          device=dev)
    certify_levels(edges, bfs.assemble_distances(pc, fn(arrays, root)[0]), root, dev)
    d_owned = sssp.build_sssp_fn(pc, sssp.SSSPConfig(fanout=fanout), device=dev)(
        arrays, root)[0]
    sssp_certificate(*edges, sssp_dist(d_owned, vertex_slots(pc, dev)), root)
    del arrays, edges, d_owned
    out = dict(inserts=int(update.ins_src.size), refuse_ms=refuse_ms,
               compact_s=t[1] - t[0], partition_s=t[2] - t[1], m=gc.n_edges,
               emax=(pg.emax, pc.emax))
    log(f"  overflow: {out['inserts']:,} directed inserts refused atomically in "
        f"{refuse_ms:.1f} ms (every array byte-equal); compaction {out['compact_s']:.1f} s, "
        f"partition {out['partition_s']:.1f} s (emax {pg.emax:,} -> {pc.emax:,}, "
        f"m {gc.n_edges:,}); fresh BFS and SSSP from root {root} certified")
    return out


def run_wave_repair(scale, edge_factor, ranks, fanout, seed, dev, n_rows_kept=WAVE_SUSPECTS):
    """Phase 18: ``repair_rows`` over ``n_rows_kept`` cached BFS rows of a
    Kronecker graph of ``scale`` after a mixed batch (two 32-lane waves:
    32 suspects and the rest), each row against the from-scratch plain
    BFS of the mutated partition.  Returns the summary, a function that
    runs the repair again (for the profile) and the flat OR-sync width.
    Its 32-lane distance columns, replicated on the 16 ranks, are why it
    runs at scale 21 (PERF.md section 4); it runs before the mutation
    phases, with the least held on the card."""
    import numpy as np

    from repro_torch.analytics import msbfs
    from repro_torch.analytics.engine import BFSQueryEngine
    from repro_torch.core import bfs, collectives
    from repro_torch.dynamic import delta, repair
    from repro_torch.graph import csr, generators, partition
    from repro_torch.traversal import sssp

    t0 = time.perf_counter()
    g = generators.kronecker(scale, edge_factor, seed=seed, max_weight=WEIGHT)
    pg = partition.partition_1d(g, ranks)
    roots = csr.largest_component_roots(g, n_rows_kept, np.random.default_rng(seed + 7))
    eng = BFSQueryEngine(pg, bfs.BFSConfig(fanout=fanout), lanes=LANES, device=dev)
    rows = list(eng.query(roots))
    overlay = delta.DeltaOverlay(g)
    batch, kept = fitting_batch(overlay, pg, np.random.default_rng(seed + 8),
                                MUTATION_INSERTS, MUTATION_DELETES, WEIGHT)
    update = overlay.apply(batch)
    if not delta.apply_update_to_partition(pg, update):
        raise AssertionError("wave: the in-place patch refused a batch cut to the slack")
    eng.refresh_arrays()
    setup_s = time.perf_counter() - t0
    suspects = sum(1 for row in rows
                   if any(x.size for x in repair.repair_seeds(row, update, unit_weight=True)))
    if suspects <= LANES:
        raise AssertionError(f"wave: {suspects} suspects fill one wave, not two")
    cfg = sssp.SSSPConfig(fanout=fanout)
    comm = collectives.Communicator(pg.p, dev)
    got, ms, launches, peak = timed_run(repair.repair_rows, pg, rows, update, cfg,
                                        unit_weight=True, arrays=eng._arrays, device=dev,
                                        comm=comm)
    if not launches["bitmap_or_reduce"]:
        raise AssertionError("wave: the repair waves never launched bitmap_or_reduce")
    single = bfs.build_bfs_fn(pg, bfs.BFSConfig(fanout=fanout, mode="direction_optimizing"),
                              device=dev)
    t1 = time.perf_counter()
    for r, row, (new, touched, iters) in zip(roots.tolist(), rows, got):
        if not np.array_equal(new, bfs.assemble_distances(pg, single(eng._arrays, r)[0])):
            raise AssertionError(f"wave: root {r}'s repaired row differs from scratch")
    scratch_ms = (time.perf_counter() - t1) * 1e3 / len(rows)
    n_rows = sssp.dist_rows(pg)
    summary = dict(scale=scale, n=g.n, m=g.n_edges, n_rows=n_rows, rows=len(rows),
                   suspects=suspects, inserts=int(update.ins_src.size),
                   deletes=int(update.del_src.size), kept_inserts=kept, ms=ms,
                   iters=[x[2] for x in got], touched=[x[1] for x in got],
                   bytes_per_rank=int(comm.bytes_sent[0]), launches=launches,
                   peak_bytes=peak, setup_s=setup_s, scratch_ms_per_row=scratch_ms)
    log(f"  wave: scale {scale} (n {g.n:,}, m {g.n_edges:,}, dist_rows {n_rows:,}), "
        f"{summary['inserts']} inserts / {summary['deletes']} deletes, {len(rows)} rows "
        f"({suspects} suspects, two waves) repaired in {ms:.1f} ms, iterations "
        f"{sorted(set(summary['iters']))}, touched {min(summary['touched']):,}.."
        f"{max(summary['touched']):,}; {summary['bytes_per_rank']:,} B per rank; launches "
        f"{launches}; peak {peak / 1e9:.2f} GB; every row == plain BFS from scratch "
        f"({scratch_ms:.1f} ms a row); set-up {setup_s:.1f} s")
    rerun = lambda: repair.repair_rows(pg, rows, update, cfg, unit_weight=True,  # noqa: E731
                                       arrays=eng._arrays, device=dev)
    return summary, rerun, n_rows * msbfs.lane_words(LANES)


def run_engine(parts, fanout, seed, dev, single, sssp_rows, mut):
    """Phase 21: the query engine on the Kronecker graph: ``query`` of
    ``LANES`` distinct roots (phase 11's) and 8 duplicates in one wave,
    each row equal to the single-source kernel BFS and ``deduped_roots`` 8;
    ``sssp`` of two roots equal to phase 12's distances; ``cc`` equal to
    the host components; a second engine on the same key builds nothing;
    the mutation engine, refreshed after the in-place patches, answers for
    the mutated graph (phase 19's from-scratch rows)."""
    import numpy as np

    from repro_torch.analytics import engine as engine_mod
    from repro_torch.core import bfs
    from repro_torch.graph import csr
    from repro_torch.traversal import sssp

    g, pg, arrays = parts["g"], parts["pg"], parts["arrays"]
    cfg = bfs.BFSConfig(fanout=fanout, mode="direction_optimizing")
    eng = engine_mod.BFSQueryEngine(pg, cfg, lanes=LANES, device=dev)
    roots = csr.largest_component_roots(g, LANES, np.random.default_rng(seed + 1),
                                        labels=parts["labels"]).tolist()
    asked = roots + roots[:8]
    eng.query(roots[:1])  # warm-up
    waves0 = eng.stats.waves
    dist, ms, launches, peak = timed_run(eng.query, asked)
    if eng.stats.waves - waves0 != 1 or eng.stats.deduped_roots != 8:
        raise AssertionError(f"engine: {eng.stats}")
    for b, r in enumerate(asked):
        if not np.array_equal(dist[b], bfs.assemble_distances(pg, single(arrays, r)[0])):
            raise AssertionError(f"engine: row {b} (root {r}) differs from the single BFS")
    del dist
    two = list(sssp_rows)[:2]
    got, sssp_ms, _, _ = timed_run(eng.sssp, two)
    for r, row in zip(two, got):
        if not np.array_equal(row, sssp.assemble_distances(pg, sssp_rows[r])):
            raise AssertionError(f"engine: sssp root {r} differs from phase 12")
    labels, cc_ms, _, _ = timed_run(eng.vertex_program, "cc")
    if not np.array_equal(labels, min_id_labels(parts["labels"])):
        raise AssertionError("engine: cc labels differ from the host components")
    builds = engine_mod._BUILDS.value(algo="bfs")
    hits = engine_mod._CACHE_EVENTS.value(event="hit")
    again = engine_mod.BFSQueryEngine(pg, cfg, lanes=LANES, device=dev)
    if again._fn is not eng._fn or engine_mod._BUILDS.value(algo="bfs") != builds \
            or engine_mod._CACHE_EVENTS.value(event="hit") != hits + 1:
        raise AssertionError("engine: a second engine on the same key built a program")
    del again
    mroots = mut["roots"]
    mdist, refresh_ms, _, _ = timed_run(mut["engine"].query, mroots)
    for r, row in zip(mroots, mdist):
        if not np.array_equal(row, mut["rows"]["bfs", r]):
            raise AssertionError(f"engine: refreshed root {r} differs from the mutated graph")
    summary = dict(ms=ms, roots=len(roots), asked=len(asked), waves=1, deduped=8,
                   launches=launches, peak_bytes=peak, sssp_ms=sssp_ms, cc_ms=cc_ms,
                   refreshed_query_ms=refresh_ms, scanned=eng.stats.scanned_edges,
                   levels=eng.stats.max_levels)
    log(f"  engine: {len(asked)} queries ({len(roots)} distinct) in one wave, {ms:.1f} ms, "
        f"== single-source BFS, 8 folded; launches {launches}; peak {peak / 1e9:.2f} GB; "
        f"sssp {len(two)} roots {sssp_ms:.1f} ms == phase 12; cc {cc_ms:.1f} ms == host; "
        f"a second engine built nothing (cache hit); the refreshed mutation engine's "
        f"{len(mroots)} rows == from scratch on the mutated graph ({refresh_ms:.1f} ms)")
    return summary


# ---------------------------------------------------------------------------
# The serving stack and the profiler (phases 23-25)
# ---------------------------------------------------------------------------

# the service at full size: result-cache rows (an int64 row is 8 B a vertex,
# 67 MB at scale 23: 64 rows hold 4.3 GB of host memory, PERF.md section 4),
# distinct BFS roots with their duplicates, closeness roots (among them),
# repeats after the answers, and the device-repair budget a batch (a lane
# repair wave at scale 23 does not fit the card, PERF.md section 4)
SERVICE_CACHE_ROWS = 64
SERVICE_ROOTS = 40
SERVICE_DUPLICATES = 10
SERVICE_CLOSENESS = 10
SERVICE_REPEATS = 36
SERVICE_REPAIR_BUDGET = 1
# PageRank's agreement between two converged runs: 2 tol d / (1 - d) at
# phase 14's tol 1e-5 and damping 0.85
PR_SLACK = 2 * 1e-5 * 0.85 / 0.15
# the serving CLI: Kronecker scale, seconds and rate of open-loop load,
# chaos, mutation batches a second and their undirected inserts
CLI_SCALE = 20
CLI_SECONDS = 5.0
CLI_QPS = 10.0
CLI_CHAOS = "kill-one@op=20"
CLI_CHAOS_SEED = 7
CLI_MUTATE_RATE = 2.0
CLI_MUTATE_EDGES = 4
# the keys of the reference's serve_graph_stats/v2 document and its
# telemetry's faults block
STATS_KEYS = {"schema", "algo", "graph", "devices", "config", "timing_ms",
              "engine_stats", "telemetry", "slo"}
FAULT_KEYS = {"injected", "schedule", "retries", "hedges", "failovers", "recoveries",
              "shed", "stale_serves", "catch_up_batches", "suspect_marks"}


def service_stream(parts, seed, sssp_roots):
    """Phase 23's seeded request stream: ``bfs`` on ``SERVICE_ROOTS``
    distinct largest-component roots and ``SERVICE_DUPLICATES`` duplicates,
    ``closeness`` on some of those roots, ``sssp`` on ``sssp_roots`` (phase
    12's), one ``cc`` and one ``pagerank``, in a seeded order (the burst);
    then the repeats of answered roots.  Returns ``(burst, repeats)``, each
    ``[(algo, root)]``."""
    import numpy as np

    from repro_torch.graph import csr

    rng = np.random.default_rng(seed + 9)
    roots = csr.largest_component_roots(parts["g"], SERVICE_ROOTS, rng,
                                        labels=parts["labels"]).tolist()
    burst = [("bfs", r) for r in roots]
    burst += [("bfs", int(r)) for r in rng.choice(roots, SERVICE_DUPLICATES)]
    burst += [("closeness", int(r)) for r in rng.choice(roots, SERVICE_CLOSENESS,
                                                        replace=False)]
    burst += [("sssp", int(r)) for r in sssp_roots] + [("cc", 0), ("pagerank", 0)]
    burst = [burst[i] for i in rng.permutation(len(burst))]
    answered = [x for x in burst if x[0] in ("bfs", "closeness")]
    repeats = [answered[i] for i in rng.choice(len(answered), SERVICE_REPEATS,
                                               replace=False)]
    return burst, repeats


def run_service(parts, fanout, seed, dev, single, sssp_rows, ranks):
    """Phase 23: ``GraphQueryService`` on a deep copy of the weighted
    Kronecker partition (the later phases keep the original), the burst of
    :func:`service_stream` queued before the scheduler starts, then its
    repeats.  Every answer equals the direct path: ``bfs`` the single-source
    kernel BFS (``single``), ``closeness`` ``measures.closeness_centrality``
    of it, ``sssp`` phase 12's distances, ``cc`` the host components (phase
    15's labels), ``pagerank`` phase 14's ranks within ``PR_SLACK``.
    Duplicates fold, the repeats cost zero waves.  Then a batch cut to the
    slack (``fitting_batch``) through ``apply_updates``: every cached row
    that survives or is repaired equals the from-scratch traversal of the
    mutated copy.  Returns the summary."""
    import copy

    import numpy as np
    import torch

    from repro_torch.analytics import measures
    from repro_torch.core import bfs
    from repro_torch.kernels import build
    from repro_torch.service import GraphQueryService
    from repro_torch.traversal import sssp

    g, pg0, arrays = parts["g"], parts["pg"], parts["arrays"]
    t0 = time.perf_counter()
    pg = copy.deepcopy(pg0)
    cfg = bfs.BFSConfig(fanout=fanout, mode="direction_optimizing")
    svc = GraphQueryService(pg, dev, cfg, lanes=LANES, n_real=g.n_real,
                            cache_capacity=SERVICE_CACHE_ROWS,
                            repair_budget=SERVICE_REPAIR_BUDGET, start=False)
    try:
        setup_s = time.perf_counter() - t0
        burst, repeats = service_stream(parts, seed, list(sssp_rows)[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t1 = time.perf_counter()
        futs = [svc.submit(a, r) for a, r in burst]
        svc.start()
        answers = [f.result(timeout=1800) for f in futs]
        serve_s = time.perf_counter() - t1
        launches, peak = dict(build.LAUNCHES), torch.cuda.max_memory_allocated()
        waves = svc.engine.stats.waves
        snap = svc.snapshot()
        t2 = time.perf_counter()
        for (algo, r), got in zip(burst, answers):
            if algo in ("bfs", "closeness"):
                want = bfs.assemble_distances(pg0, single(arrays, r)[0])
                if algo == "closeness":
                    want = float(measures.closeness_centrality(want[None, :], n=g.n_real)[0])
                ok = got == want if algo == "closeness" else np.array_equal(got, want)
            elif algo == "sssp":
                ok = np.array_equal(got, sssp.assemble_distances(pg0, sssp_rows[r]))
            elif algo == "cc":
                ok = np.array_equal(got, min_id_labels(parts["labels"]))
            else:
                ok = float(np.max(np.abs(got - ranks["pagerank"]))) <= PR_SLACK
            if not ok:
                raise AssertionError(f"service: {algo} root {r} differs from the direct path")
        check_s = time.perf_counter() - t2
        if snap["coalesced_roots"] < SERVICE_DUPLICATES:
            raise AssertionError(f"service: {snap['coalesced_roots']} riders folded, "
                                 f"expected at least {SERVICE_DUPLICATES}")
        hits0 = snap["cache"]["hits"]
        t3 = time.perf_counter()
        again = [svc.submit(a, r).result(timeout=60) for a, r in repeats]
        repeat_ms = (time.perf_counter() - t3) * 1e3
        if svc.engine.stats.waves != waves:
            raise AssertionError("service: the repeats ran waves")
        for (algo, r), got in zip(repeats, again):
            want = answers[burst.index((algo, r))]
            if not (got == want if algo == "closeness" else np.array_equal(got, want)):
                raise AssertionError(f"service: repeat {algo} {r} differs from its answer")
        snap = svc.snapshot()
        if snap["cache"]["hits"] - hits0 != len(repeats):
            raise AssertionError(f"service: {snap['cache']['hits'] - hits0} cache hits "
                                 f"for {len(repeats)} repeats")
        lat = snap["latency_ms"]
        summary = dict(
            requests=len(burst) + len(repeats), burst=len(burst), repeats=len(repeats),
            setup_s=setup_s, serve_s=serve_s, check_s=check_s, repeat_ms=repeat_ms,
            waves=waves, p50_ms=lat["p50"], p99_ms=lat["p99"],
            occupancy=snap["wave_occupancy"], hit_rate=snap["cache"]["hit_rate"],
            coalesced=snap["coalesced_roots"], launches=launches,
            merges_per_wave=launches["bitmap_or_reduce"] / max(waves, 1),
            peak_bytes=peak, cached_rows=len(svc.cache))
        log(f"  service: {len(burst)} requests in {serve_s:.1f} s ({waves} waves, "
            f"{snap['coalesced_roots']} riders folded, occupancy {snap['wave_occupancy']:.3f}); "
            f"request-to-answer p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms; every answer "
            f"== the direct path ({check_s:.1f} s of checks); {len(repeats)} repeats in "
            f"{repeat_ms:.1f} ms, 0 waves, all cache hits (hit rate "
            f"{snap['cache']['hit_rate']:.3f}); bitmap_or_reduce "
            f"{summary['merges_per_wave']:.1f} a wave ({launches}); peak "
            f"{peak / 1e9:.2f} GB; set-up {setup_s:.1f} s")
        summary["mutation"] = service_mutation(svc, parts, fanout, seed, dev)
        return summary
    finally:
        svc.stop()


def service_mutation(svc, parts, fanout, seed, dev):
    """The second half of phase 23: ``apply_updates`` of a seeded batch cut
    to the copy's slack; every cached row under the new version (kept or
    repaired) equals the from-scratch traversal of the mutated copy: BFS
    and SSSP rows bit for bit, closeness from the scratch BFS row, PageRank
    within ``PR_SLACK`` of a cold run."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.analytics import measures
    from repro_torch.dynamic import versioning
    from repro_torch.kernels import build

    captured = []
    real = versioning.migrate_cache

    def capture(*a, **kw):
        captured.append(real(*a, **kw))
        return captured[-1]

    pg = svc.engine.pg
    t0 = time.perf_counter()
    overlay = svc.overlay
    batch, kept_inserts = fitting_batch(overlay, pg, np.random.default_rng(seed + 10),
                                        MUTATION_INSERTS, MUTATION_DELETES, WEIGHT)
    overlay_s = time.perf_counter() - t0
    versioning.migrate_cache = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t1 = time.perf_counter()
        version = svc.apply_updates(batch)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t1) * 1e3
    finally:
        versioning.migrate_cache = real
    launches, peak = dict(build.LAUNCHES), torch.cuda.max_memory_allocated()
    if len(captured) != 1 or version.delta_seq != 1:
        raise AssertionError(f"service: the batch took the swap path ({version})")
    stats = captured[0]
    scratch = scratch_fns(pg, fanout, dev)
    arrays = svc.engine._arrays
    rows, checked = svc.cache.items_snapshot(), {}
    t2 = time.perf_counter()
    cold = None
    for key, value in rows:
        if key[0] != version:
            continue
        algo, root = key[1], key[3]
        if algo in ("bfs", "sssp", "closeness"):
            want = scratch["sssp" if algo == "sssp" else "bfs"](arrays, root)
            if algo == "closeness":
                want = float(measures.closeness_centrality(want[None, :], n=svc.n_real)[0])
            ok = value == want if algo == "closeness" else np.array_equal(value, want)
        elif algo == "pagerank":
            if cold is None:
                cold = svc.engine.vertex_program("pagerank", svc.program_cfg)
            ok = float(np.max(np.abs(value - cold))) <= PR_SLACK
        else:
            raise AssertionError(f"service: a cached {algo} row survived the batch")
        if not ok:
            raise AssertionError(f"service: cached {algo} root {root} differs from the "
                                 f"from-scratch traversal of the mutated copy")
        checked[algo] = checked.get(algo, 0) + 1
    if sum(checked.values()) != stats.kept + stats.repaired:
        raise AssertionError(f"service: {checked} rows under {version}, stats {stats}")
    out = dict(inserts=kept_inserts, deletes=int(batch.delete_src.size),
               overlay_s=overlay_s, apply_ms=apply_ms, launches=launches, peak_bytes=peak,
               stats=dc.asdict(stats), checked=checked,
               check_s=time.perf_counter() - t2, version=str(version))
    log(f"  service mutation: {kept_inserts} undirected inserts / {out['deletes']} deletes "
        f"applied in {apply_ms:.1f} ms ({version}; overlay built in {overlay_s:.1f} s); "
        f"{stats}; launches {launches}; peak {peak / 1e9:.2f} GB; every surviving row "
        f"== from scratch on the mutated copy {checked} ({out['check_s']:.1f} s)")
    return out


def run_serving_cli(scale, edge_factor, ranks, fanout, seed, out_dir, dev_name="cuda",
                    seconds=CLI_SECONDS):
    """Phase 24: ``repro_torch.launch.serve_graph.main`` in this process: two
    replicas behind the router, ``CLI_CHAOS`` killing one, mutation batches
    through the replication log, the event log, the SLOs of
    ``examples/slo_chaos.json`` and the stats, all written to ``out_dir``.
    No future fails; the faults block shows one kill and one recovery; the
    stats have the reference's ``serve_graph_stats/v2`` keys; every event
    line validates against ``tests/event_schema.json``; the SLO verdict is
    there.  Returns the summary."""
    import json as _json

    import torch

    from repro_torch.core import events
    from repro_torch.launch import serve_graph

    os.makedirs(out_dir, exist_ok=True)
    path = {k: os.path.join(out_dir, f) for k, f in (
        ("stats", "stats.json"), ("events", "events.jsonl"), ("verdict", "slo_verdict.json"))}
    for f in path.values():
        if os.path.exists(f):
            os.remove(f)
    argv = ["--scale", str(scale), "--edge-factor", str(edge_factor), "--ranks", str(ranks),
            "--fanout", str(fanout), "--device", dev_name, "--seed", str(seed),
            "--qps", str(CLI_QPS), "--duration", str(seconds), "--replicas", "2",
            "--chaos", CLI_CHAOS, "--chaos-seed", str(CLI_CHAOS_SEED),
            "--mutate-rate", str(CLI_MUTATE_RATE), "--mutate-edges", str(CLI_MUTATE_EDGES),
            "--events", path["events"], "--slo-config",
            os.path.join(ROOT, "examples", "slo_chaos.json"),
            "--slo-verdict", path["verdict"], "--stats-json", path["stats"]]
    log(f"  serve_graph {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if serve_graph.main(argv) != 0:
        raise AssertionError("serve_graph: non-zero exit")
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(path["stats"]) as f:
        doc = _json.load(f)
    tele = doc["telemetry"]
    fb = tele["faults"]
    if set(doc) != STATS_KEYS or set(fb) != FAULT_KEYS \
            or doc["schema"] != "serve_graph_stats/v2":
        raise AssertionError(f"serve_graph: stats keys {sorted(doc)}, faults {sorted(fb)}")
    if tele["failed"] or tele["completed"] != tele["submitted"]:
        raise AssertionError(f"serve_graph: {tele['failed']} failed of "
                             f"{tele['submitted']} submitted, {tele['completed']} completed")
    if fb["injected"].get("kill-replica") != 1 or fb["recoveries"] != 1:
        raise AssertionError(f"serve_graph: faults {fb}")
    with open(os.path.join(ROOT, "tests", "event_schema.json")) as f:
        errs = events.validate_events_file(path["events"], _json.load(f))
    with open(path["events"]) as f:
        n_events = sum(1 for line in f if line.strip())
    if errs or not n_events:
        raise AssertionError(f"serve_graph: {n_events} events, violations {errs[:5]}")
    with open(path["verdict"]) as f:
        verdict = _json.load(f)
    if verdict.get("schema") != "slo_verdict/v1" or doc["slo"] is None:
        raise AssertionError("serve_graph: no SLO verdict")
    lat = tele["latency_ms"]
    summary = dict(scale=scale, wall_s=wall_s, submitted=tele["submitted"],
                   completed=tele["completed"], failed=tele["failed"], p50_ms=lat["p50"],
                   p99_ms=lat["p99"], qps=tele["qps"], faults=fb, events=n_events,
                   slo_ok=verdict["ok"], slo_any_fired=verdict["any_fired"],
                   peak_bytes=peak)
    log(f"  serving CLI: scale {scale}, 2 replicas, {CLI_CHAOS} (seed {CLI_CHAOS_SEED}): "
        f"{tele['completed']}/{tele['submitted']} completed, 0 failed; p50 {lat['p50']:.1f} "
        f"ms, p99 {lat['p99']:.1f} ms; kills 1, recoveries {fb['recoveries']}, failovers "
        f"{fb['failovers']}, catch-up batches {fb['catch_up_batches']}; {n_events} events "
        f"valid; SLO ok={verdict['ok']} any_fired={verdict['any_fired']}; stats keys == "
        f"the reference's; {wall_s:.1f} s; peak {peak / 1e9:.2f} GB")
    return summary


def run_profiler(parts, fanout, dev, root, single):
    """Phase 25: ``BFSQueryEngine.profile`` on the Kronecker graph (the
    engine of phase 21's config, its programs from the cache), on the
    kernel path with the ETL's layout: the byte model reconciles with the
    Communicator exactly, the per-level directions equal phase 7's for the
    root, every supported cached program reconciles, and the three kernels
    of the path launch.  Returns the summary."""
    import torch

    from repro_torch.analytics.engine import BFSQueryEngine
    from repro_torch.core import bfs
    from repro_torch.kernels import build

    cfg = bfs.BFSConfig(fanout=fanout, mode="direction_optimizing")
    eng = BFSQueryEngine(parts["pg"], cfg, lanes=LANES, device=dev)
    with direction_log() as seq:
        single(parts["arrays"], root)
    report, ms, launches, peak = timed_run(eng.profile, root, layout=parts["layout"])
    prof, cache = report["program"], report["cache"]
    dirs = [r.direction for r in prof.per_level]
    if not prof.reconciled or prof.wire_efficiency != 1.0:
        raise AssertionError(f"profile: not reconciled ({prof.model_bytes} / {prof.hlo_bytes})")
    if dirs != seq:
        raise AssertionError(f"profile: directions {dirs} != phase 7's {seq}")
    bad = [c.algo for c in cache if c.supported and not c.reconciled]
    if bad or not any(c.supported for c in cache):
        raise AssertionError(f"profile: cached programs not reconciled: {bad} of "
                             f"{[c.algo for c in cache]}")
    idle = [k for k in ("frontier_gather_full", "frontier_scatter", "bitmap_or_reduce")
            if not launches[k]]
    if idle:
        raise AssertionError(f"profile: {idle} never launched ({launches})")
    rf = prof.roofline
    summary = dict(root=root, ms=ms, wall_ms=prof.wall_ms, levels=prof.levels,
                   achieved_gteps=prof.achieved_gteps, modeled_gteps=prof.modeled_gteps,
                   dominant=rf["dominant"], t_memory=rf["t_memory"],
                   t_collective=rf["t_collective"], kernel_bytes=rf["kernel_bytes"],
                   kernel_calls=rf["kernel_calls"], bytes_per_rank=prof.hlo_bytes["total"],
                   directions=dirs, launches=launches, peak_bytes=peak,
                   cache=[c.to_dict() for c in cache])
    log(f"  profile root {root}: {prof.levels} levels ({run_lengths(dirs)} == phase 7), "
        f"wall {prof.wall_ms:.3f} ms min of 3; achieved {prof.achieved_gteps:.4f} GTEP/s "
        f"vs modeled {prof.modeled_gteps:.4f}, dominant {rf['dominant']} (memory "
        f"{rf['t_memory'] * 1e3:.3f} ms for {rf['bytes_per_device'] / 1e9:.3f} GB, network "
        f"{rf['t_collective'] * 1e3:.3f} ms for {prof.hlo_bytes['total']:,.0f} B a rank); "
        f"reconciled; cache {[(c.algo, c.reconciled if c.supported else 'unsupported') for c in cache]}; "
        f"launches {launches}; {ms:.0f} ms in all; peak {peak / 1e9:.2f} GB")
    del eng
    torch.cuda.empty_cache()
    return summary



# ---------------------------------------------------------------------------
# The LM serving path (phase 3)
# ---------------------------------------------------------------------------

# the served model at its published size, bfloat16: prompts, new tokens and
# the sampled run's settings
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_TEMPERATURE, LM_TOP_K = 0.8, 50
# float32 consistency: (arch, batch, prefill tokens, teacher-forced steps);
# qwen3-1.7b's prefill runs 3 query chunks of 1024, its forward over 3136
# tokens chunks of 64; mamba2-130m's prefill 4 SSD chunks of 256, its
# forward over 1056 tokens chunks of 32
LM_CHECKS = (("qwen3-1.7b", 2, 3072, 64), ("mamba2-130m", 2, 1024, 32))
# tests/test_models.py:121-123, the reference's own prefill/decode tolerance
LM_RTOL, LM_ATOL = 2e-2, 2e-3
# every arch's reduced config on the card against the port on the CPU
CARD_TOL, CARD_PROMPT, CARD_STEPS = 1e-4, 16, 4
LM_PROFILE_STEPS = 4


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls in float32 (TF32 off) inside the block."""
    import torch

    old = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]


def check_close(label, got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` everywhere, or raise; returns the
    largest absolute error and the largest share of the tolerance used."""
    import torch

    got, want = got.float(), want.float().to(got.device)
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    out = dict(max_abs_err=float(err.max()), tol_share=share, rtol=rtol, atol=atol)
    if not torch.isfinite(got).all() or share > 1.0:
        raise AssertionError(f"{label}: outside rtol {rtol} atol {atol}: {out}")
    return out


def kv_bytes_per_token(cfg) -> int:
    """K and V of one token over every attention layer, in the cache's dtype."""
    from repro_torch.dist.sharding import DTYPES

    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    return (n_attn * 2 * cfg.n_kv_heads * cfg.resolved_head_dim
            * DTYPES[cfg.param_dtype].itemsize)


def timed_generate(cfg, model, prompts, n_new, rules=None, mesh=None, extra=None):
    """``engine.generate``'s greedy loop step by step, each bracketed by CUDA
    events: (tokens, prefill ms, decode ms of every step); ``rules`` and
    ``mesh`` as ``generate`` takes them (a sharded model), ``extra`` its
    ``extra_inputs`` (patches, frames)."""
    import torch

    from repro_torch.models import api
    from repro_torch.serve import engine

    prefill, decode = api.prefill_fn(cfg, rules, mesh), api.decode_fn(cfg, rules, mesh)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_new + 1)]
    with torch.inference_mode():
        torch.cuda.synchronize()
        marks[0].record()
        logits, cache, pos = prefill(model, dict(extra or {}, tokens=prompts))
        cache = engine.prepare_decode_cache(cfg, cache, pos, pos + n_new)
        tok = engine.sample(logits)
        marks[1].record()
        out = [tok]
        for i in range(n_new - 1):
            logits, cache = decode(model, cache, tok[:, None], pos + i)
            tok = engine.sample(logits)
            marks[i + 2].record()
            out.append(tok)
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return torch.stack(out, dim=1).cpu().numpy(), ms[0], ms[1:]


def lm_serve(dev, seed):
    """qwen3-1.7b at its published size in bfloat16, weights from a seeded
    generator on the card: ``serve.engine.generate`` of ``LM_BATCH`` seeded
    prompts of ``LM_PROMPT`` tokens, ``LM_NEW`` greedy new tokens, twice
    (identical), every id in the vocabulary, the first token equal to the
    argmax of ``lm_logits`` on ``forward_hidden``'s last position; the same
    loop timed step by step (the same tokens); a sampled run twice (valid,
    repeatable). The decode step's least time: the weights (the tied head
    read once) and the KV cache's valid entries over HBM."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api, lm
    from repro_torch.serve import engine

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if n_params != api.param_counts(cfg)["total"]:
        raise AssertionError(f"{LM_ARCH}: {n_params} parameters, the config has "
                             f"{api.param_counts(cfg)['total']}")
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV) of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} padded to {cfg.padded_vocab}; {n_params:,} parameters, "
        f"{weight_bytes / 1e9:.3f} GB in {cfg.param_dtype}, seeded in {init_s:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev,
                            dtype=torch.int32)
    engine.generate(cfg, model, prompts, 4)  # warm-up
    walls, runs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(engine.generate(cfg, model, prompts, LM_NEW).tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    greedy = runs[0]
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("greedy generate: two runs differ")
    if greedy.shape != (LM_BATCH, LM_NEW) or greedy.min() < 0 or greedy.max() >= cfg.vocab:
        raise AssertionError(f"greedy ids outside [0, {cfg.vocab}): {greedy.min()}.."
                             f"{greedy.max()}, shape {greedy.shape}")
    with torch.inference_mode():
        h = lm.forward_hidden(cfg, model, prompts)
        first = torch.argmax(lm.lm_logits(cfg, model, h[:, -1]), -1).cpu().numpy()
        del h
    if not np.array_equal(greedy[:, 0], first):
        raise AssertionError(f"first token {greedy[:, 0]} != forward argmax {first}")
    timed, prefill_ms, step_ms = timed_generate(cfg, model, prompts, LM_NEW)
    if not np.array_equal(timed, greedy):
        raise AssertionError("the step-timed loop's tokens differ from generate's")
    sampled = [engine.generate(cfg, model, prompts, LM_NEW, temperature=LM_TEMPERATURE,
                               top_k=LM_TOP_K, seed=seed + 1).tokens for _ in range(2)]
    if not np.array_equal(sampled[0], sampled[1]):
        raise AssertionError("sampled generate: two runs with one seed differ")
    if sampled[0].min() < 0 or sampled[0].max() >= cfg.vocab:
        raise AssertionError("sampled ids outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    kv_tok = kv_bytes_per_token(cfg)
    # decode step i writes position LM_PROMPT + i and reads that many + 1
    bound_ms = [(weight_bytes + LM_BATCH * (LM_PROMPT + i + 1) * kv_tok)
                / HBM_BYTES_PER_S * 1e3 for i in range(LM_NEW - 1)]
    med, med_bound = float(np.median(step_ms)), float(np.median(bound_ms))
    toks = LM_BATCH * LM_NEW
    out = dict(arch=cfg.name, params=n_params, weight_bytes=weight_bytes, init_s=init_s,
               batch=LM_BATCH, prompt=LM_PROMPT, new=LM_NEW, generate_s=walls,
               tokens_per_s=[toks / w for w in walls], prefill_ms=prefill_ms,
               decode_ms_median=med, decode_ms_min=min(step_ms), decode_ms_max=max(step_ms),
               decode_bound_ms_median=med_bound, kv_bytes_per_token=kv_tok,
               decode_tokens_per_s=LM_BATCH / med * 1e3, peak_bytes=peak,
               distinct_greedy=int(len(np.unique(greedy))),
               distinct_sampled=int(len(np.unique(sampled[0]))),
               sampled_differs=bool(not np.array_equal(sampled[0], greedy)))
    log(f"  generate {LM_BATCH} x ({LM_PROMPT} + {LM_NEW} greedy): "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, "
        f"{', '.join(f'{t:.1f}' for t in out['tokens_per_s'])} tokens/s; identical, ids in "
        f"[0, {cfg.vocab}), first == forward argmax; {out['distinct_greedy']} distinct ids")
    log(f"  step by step: prefill {prefill_ms:.2f} ms; decode median {med:.3f} ms a step "
        f"({min(step_ms):.3f}-{max(step_ms):.3f}; {out['decode_tokens_per_s']:.1f} tokens/s) "
        f"against a least {med_bound:.3f} ms over HBM ({weight_bytes / 1e9:.3f} GB of "
        f"weights + KV {kv_tok:,} B a token x {LM_BATCH} x ~{LM_PROMPT + LM_NEW // 2}): "
        f"{med_bound / med:.1%} of the bound")
    log(f"  sampled (temperature {LM_TEMPERATURE}, top-k {LM_TOP_K}, seed {seed + 1}): "
        f"repeatable, ids valid, {out['distinct_sampled']} distinct; peak device memory "
        f"{peak / 1e9:.2f} GB")
    return out, model, prompts


def lm_consistency(arch, batch, n_prefill, n_steps, dev, seed):
    """Prefill ``n_prefill`` tokens then ``n_steps`` teacher-forced decode
    steps, float32 with TF32 off: the ``n_steps + 1`` logit rows against
    ``lm_logits(forward_hidden(...))`` over the same tokens, at the
    reference's own tolerance."""
    import dataclasses as dc

    import torch

    from repro_torch import configs
    from repro_torch.models import api, layers, lm, mamba2
    from repro_torch.serve import engine

    cfg = dc.replace(configs.get_config(arch), param_dtype="float32",
                     compute_dtype="float32")
    n = n_prefill + n_steps
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with exact_float32(), torch.inference_mode():
        model = api.init_params(cfg, seed, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        toks = torch.randint(0, cfg.vocab, (batch, n), generator=gen, device=dev,
                             dtype=torch.int32)
        logits, cache, pos = api.prefill_fn(cfg)(model, {"tokens": toks[:, :n_prefill]})
        cache = engine.prepare_decode_cache(cfg, cache, pos, n)
        rows = [logits]
        for i in range(n_steps):
            logits, cache = api.decode_fn(cfg)(model, cache, toks[:, pos + i:pos + i + 1],
                                               pos + i)
            rows.append(logits)
        got = torch.stack(rows, dim=1)
        del cache, rows
        h = lm.forward_hidden(cfg, model, toks)
        want = lm.lm_logits(cfg, model, h[:, n_prefill - 1:])
        del h, model
    torch.cuda.synchronize()
    if cfg.family == "ssm":
        plan = [f"SSD chunk {mamba2.ssd_chunk(cfg.ssm_chunk, m)}" for m in (n_prefill, n)]
    else:
        plan = [f"query chunk {layers.attn_chunking(cfg, m)[0]}" for m in (n_prefill, n)]
    out = dict(arch=arch, batch=batch, prefill=n_prefill, steps=n_steps, rows=got.shape[1],
               plans=plan, seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               **check_close(f"{arch} prefill + decode against the forward", got, want,
                             LM_RTOL, LM_ATOL))
    log(f"  {arch} float32: prefill {n_prefill} ({plan[0]}) + {n_steps} decode steps == "
        f"forward over {n} ({plan[1]}), {out['rows']} rows x {cfg.padded_vocab}: max abs "
        f"err {out['max_abs_err']:.3e}, {out['tol_share']:.3f} of rtol {LM_RTOL} atol "
        f"{LM_ATOL}; {out['seconds']:.1f} s, peak {out['peak_bytes'] / 1e9:.2f} GB")
    return out


def reduced_inputs(cfg, seed):
    """Seeded prompts (and patches or frames) of a reduced config, on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, CARD_PROMPT + CARD_STEPS)),
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = torch.as_tensor(rng.normal(size=(2, cfg.n_patches, cfg.patch_dim)),
                                         dtype=torch.float32)
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(rng.normal(size=(2, cfg.n_frames, cfg.d_model)),
                                        dtype=torch.float32)
    return out


def reduced_logits(cfg, model, inputs):
    """Prefill ``CARD_PROMPT`` tokens and ``CARD_STEPS`` teacher-forced decode
    steps on the model's device: the logit rows, (B, CARD_STEPS + 1, V)."""
    import torch

    from repro_torch.models import api
    from repro_torch.serve import engine

    dev = model.embed.tok.device
    inputs = {k: v.to(dev) for k, v in inputs.items()}
    toks = inputs["tokens"]
    with torch.inference_mode():
        logits, cache, pos = api.prefill_fn(cfg)(model, dict(inputs,
                                                            tokens=toks[:, :CARD_PROMPT]))
        cache = engine.prepare_decode_cache(cfg, cache, pos, pos + CARD_STEPS)
        rows = [logits]
        for i in range(CARD_STEPS):
            t = toks[:, CARD_PROMPT + i:CARD_PROMPT + i + 1]
            logits, cache = api.decode_fn(cfg)(model, cache, t, pos + i)
            rows.append(logits)
    return torch.stack(rows, dim=1).cpu()


def lm_card_vs_cpu(dev, seed):
    """Every arch at its reduced config, float32, TF32 off: prefill and
    ``CARD_STEPS`` decode steps on the card against the same port on the
    CPU with the same weights (MoE for qwen3-moe, kimi-k2 and jamba, the
    hybrid for jamba, patches for the VLM, frames for whisper)."""
    import copy

    import torch

    from repro_torch import configs
    from repro_torch.models import api

    rows = {}
    with exact_float32():
        for arch in configs.ARCH_NAMES:
            cfg = configs.reduced(configs.get_config(arch))
            cpu = api.init_params(cfg, seed, device="cpu")
            card = copy.deepcopy(cpu).to(dev)
            inputs = reduced_inputs(cfg, seed)
            want = reduced_logits(cfg, cpu, inputs)
            got = reduced_logits(cfg, card, inputs)
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            rows[arch] = dict(greedy_agreement=agree, **check_close(
                f"{arch} card against CPU", got, want, CARD_TOL, CARD_TOL))
            log(f"  {arch:22s} max abs err {rows[arch]['max_abs_err']:.2e} "
                f"({rows[arch]['tol_share']:.3f} of the tolerance), greedy tokens agree "
                f"{agree:.0%}")
    return rows


def run_lm(dev, seed, profile_decode):
    """Phase 3: the LM serving path (module docstring, item 3). The graph
    kernels are not on this path: their counts stay 0. With
    ``profile_decode``, ``LM_PROFILE_STEPS`` decode steps run under
    ``torch.profiler`` afterwards (device busy time and top kernels)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import engine

    build.reset_launches()
    out = {}
    out["serve"], model, prompts = lm_serve(dev, seed)
    if profile_decode:
        from repro_torch import configs

        cfg = configs.get_config(LM_ARCH)
        with torch.inference_mode():
            logits, cache, pos = api.prefill_fn(cfg)(model, {"tokens": prompts})
            cache = engine.prepare_decode_cache(cfg, cache, pos, pos + LM_PROFILE_STEPS)
            tok = engine.sample(logits)

            def steps():
                t = tok
                for i in range(LM_PROFILE_STEPS):
                    lg, _ = api.decode_fn(cfg)(model, cache, t[:, None], pos + i)
                    t = engine.sample(lg)

            out["decode_profile"] = merge_profile(f"{LM_PROFILE_STEPS} decode steps", steps)
            del cache
    del model, prompts
    gc.collect()
    torch.cuda.empty_cache()
    out["consistency"] = [lm_consistency(*check, dev, seed) for check in LM_CHECKS]
    torch.cuda.empty_cache()
    out["reduced"] = lm_card_vs_cpu(dev, seed)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the LM path launched graph kernels: {launched}")
    log("  the LM path launched none of the four graph kernels")
    gc.collect()
    if dev.type == "cuda":
        # the allocator holds cuBLAS's workspace (32 MiB on Hopper) for the
        # process: give it back, so the graph phases' peak is theirs alone
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The LM training path (phase 3b)
# ---------------------------------------------------------------------------

# qwen3-1.7b at its published size trained by train.loop.train: bfloat16,
# remat, AdamW, the whole batch on the card, the config's 4 microbatches;
# 4 steps, the last 3 timed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 4
TRAIN_LR = {"peak": 3e-4, "warmup": 2, "total": 8}
H100_BF16_FLOPS = 989e12  # dense bfloat16 peak (data sheet, SXM, 700 W)
# the butterfly gradient sync at full width: P ranks of 4 rows, one row a
# microbatch, against the one-device gradient of 16 one-row microbatches
TRAIN_RANKS, SYNC_REL_TOL = 4, 1e-5
SYNC_CASES = (("xla_psum", 2), ("butterfly", 2), ("butterfly", 4), ("rabenseifner", 2),
              ("all_to_all", 2))
# restart: qwen3-1.7b's widths cut to 2 layers, failed at step 4, checkpoints
# every 3 steps, against an uninterrupted run of 6
RESTART_LAYERS, RESTART_STEPS, RESTART_FAIL, RESTART_EVERY = 2, 6, 4, 3
# every arch's reduced config: steps 1-2 on the card against the CPU
CARD_TRAIN_LR = {"peak": 1e-3, "warmup": 1, "total": 10}
CARD_TRAIN_TOL, CARD_TRAIN_BATCH, CARD_TRAIN_SEQ = 1e-5, 4, 32
# an update g / (|g| + eps) is ill-conditioned where a nonzero |g| is within
# 100x of AdamW's eps: a float32 rounding of g moves it by a share of a step
ADAM_ILL_CONDITIONED = 1e-6


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (cuBLAS's
    workspace is fixed by ``CUBLAS_WORKSPACE_CONFIG``, set at import)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def device_batch(data, step, dev):
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}


def train_published(dev, seed, profile):
    """(a) qwen3-1.7b at its published size trained ``TRAIN_STEPS`` steps by
    ``train.loop.train``: every loss finite, the last below the first; the
    step time (median of steps 2 on), tokens a second, the step's model
    FLOPs (6 N D, N the non-embedding parameters) and remat's recompute (2
    N D) against the bfloat16 peak, the peak memory; with ``profile`` one
    more step under ``torch.profiler``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import api
    from repro_torch.train import loop, step as step_mod

    cfg = configs.get_config(LM_ARCH)
    if not (cfg.remat and cfg.param_dtype == "bfloat16" and cfg.optimizer == "adamw"):
        raise AssertionError(f"{cfg.name}: expected remat, bfloat16 and AdamW")
    torch.cuda.reset_peak_memory_stats()
    rows = []
    t0 = time.perf_counter()
    out = loop.train(cfg, TRAIN_BATCH, TRAIN_SEQ,
                     loop.LoopConfig(n_steps=TRAIN_STEPS, microbatches=cfg.train_microbatches,
                                     lr_kw=TRAIN_LR, log_every=1),
                     seed=seed, on_metrics=lambda s, m: rows.append(m), device=dev)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    step_s = [r["step_time"] for r in rows]
    med = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shape = configs.ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = api.model_flops(cfg, shape)
    n_active = api.param_counts(cfg)["active"]
    remat_flops = 2.0 * n_active * tokens
    res = dict(arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               microbatches=cfg.train_microbatches, lr_kw=TRAIN_LR, losses=losses,
               grad_norms=[r["grad_norm"] for r in rows], lrs=[r["lr"] for r in rows],
               step_s=step_s, step_s_median=med, tokens_per_s=tokens / med,
               model_flops=flops, remat_flops=remat_flops,
               peak_share=flops / med / H100_BF16_FLOPS,
               executed_share=(flops + remat_flops) / med / H100_BF16_FLOPS,
               peak_bytes=peak, wall_s=wall_s)
    log(f"  {cfg.name} {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"({cfg.train_microbatches} microbatches, remat, bfloat16, AdamW): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; grad norm "
        f"{rows[0]['grad_norm']:.3f} -> {rows[-1]['grad_norm']:.3f}")
    log(f"  step {med * 1e3:.1f} ms median of steps 2-{TRAIN_STEPS} (first "
        f"{step_s[0] * 1e3:.1f} ms), {tokens / med:,.0f} tokens/s; model FLOPs 6ND "
        f"{flops:.4g} a step = {res['peak_share']:.1%} of {H100_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16; with remat's recompute 2ND ({remat_flops:.4g}) "
        f"{res['executed_share']:.1%}; peak device memory {peak / 1e9:.2f} GB; "
        f"{wall_s:.1f} s in all")
    res["roofline"] = roofline_step(cfg, out["params"], out["opt_state"], dev, med)
    if profile:
        fn = step_mod.build_train_step(cfg, microbatches=cfg.train_microbatches,
                                       lr_kw=TRAIN_LR)
        batch = device_batch(SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ), TRAIN_STEPS, dev)
        model, state = out["params"], out["opt_state"]
        prof = merge_profile("one train step", lambda: fn(model, state, batch, TRAIN_STEPS),
                             top_n=12)
        prof["busy_share"] = prof["busy_ms"] / (med * 1e3)
        log(f"  the profiled step's device time is {prof['busy_share']:.1%} of the "
            f"unprofiled step's {med * 1e3:.1f} ms")
        res["profile"] = prof
    return res, out["params"]


def roofline_step(cfg, model, state, dev, median_s):
    """Phase 3d(a): one more real train step of phase 3b's model (16 x 1024
    tokens, one microbatch: a step's flops do not depend on the
    microbatching; not one of the timed steps) inside
    ``launch.hlo_stats.measure`` (``FlopCounterMode``, the card's peak),
    and the same step at the same shape under fake tensors in this
    process (``MemTracker``'s peak): the two flop counts equal exactly.
    The modeled terms at that shape on one card (compute the flops at the
    bfloat16 peak, memory ``analytic.step_bytes`` at the HBM rate) against
    phase 3b's median step, and the card's peak against the fake one."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import analytic, hlo_stats
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    shape = configs.ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    fn = step_mod.build_train_step(cfg, microbatches=1, lr_kw=TRAIN_LR)
    batch = device_batch(SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ), TRAIN_STEPS + 1, dev)
    t0 = time.perf_counter()
    real = hlo_stats.measure(fn, model, state, batch, TRAIN_STEPS + 1)
    real_s = time.perf_counter() - t0
    real.out = None
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake_model = api.build_model(cfg, torch.device("cpu"))
        fake_batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype) for k, v in batch.items()}
        fake = hlo_stats.measure(fn, fake_model, optim.get(cfg.optimizer).init(fake_model),
                                 fake_batch, TRAIN_STEPS + 1)
    fake.out = None
    fake_s = time.perf_counter() - t0
    if real.flops != fake.flops or real.flops_by_op != fake.flops_by_op or real.flops <= 0:
        raise AssertionError(f"the real step counts {real.flops:.6g} flops "
                             f"({real.flops_by_op}), the fake one {fake.flops:.6g} "
                             f"({fake.flops_by_op})")
    step_bytes = analytic.step_bytes(cfg, shape)["global"]
    roof = hlo_stats.roofline(fake.flops, step_bytes, 0.0)
    out = dict(flops=real.flops, flops_by_op=real.flops_by_op, fake_flops=fake.flops,
               step_bytes=step_bytes, t_compute_ms=roof.t_compute * 1e3,
               t_memory_ms=roof.t_memory * 1e3, step_time_est_ms=roof.step_time * 1e3,
               dominant=roof.dominant, median_step_ms=median_s * 1e3,
               achieved_over_modeled=median_s / roof.step_time,
               real_peak_bytes=real.memory["peak_bytes_per_device"],
               fake_peak_bytes=fake.memory["peak_bytes_per_device"],
               peak_ratio=real.memory["peak_bytes_per_device"]
               / max(fake.memory["peak_bytes_per_device"], 1.0),
               real_memory=real.memory, fake_memory=fake.memory,
               real_step_s=real_s, fake_step_s=fake_s)
    log(f"  3d(a) one real step in FlopCounterMode ({real_s:.1f} s) == the same step under "
        f"fake tensors ({fake_s:.1f} s): {real.flops:.6g} flops exactly "
        f"({', '.join(f'{k} {v:.6g}' for k, v in real.flops_by_op.items())})")
    log(f"  3d(a) modeled on one card at {TRAIN_BATCH} x {TRAIN_SEQ}: compute "
        f"{out['t_compute_ms']:.1f} ms (flops / {hlo_stats.PEAK_FLOPS / 1e12:.0f} TFLOP/s), "
        f"memory {out['t_memory_ms']:.1f} ms (step_bytes {step_bytes:.4g} B / "
        f"{hlo_stats.HBM_BW / 1e12:.2f} TB/s), step_time_est {out['step_time_est_ms']:.1f} "
        f"ms ({roof.dominant}); measured median {median_s * 1e3:.1f} ms = "
        f"{out['achieved_over_modeled']:.3f}x the model")
    log(f"  3d(a) peak memory of the step: card {out['real_peak_bytes'] / 1e9:.3f} GB "
        f"(max_memory_allocated), fake {out['fake_peak_bytes'] / 1e9:.3f} GB (MemTracker): "
        f"ratio {out['peak_ratio']:.4f}")
    return out


class LevelCounts(list):
    """A ``level_ms`` list (``build_bfs_fn``'s run appends each level's wall
    ms) that also keeps the Communicator's per-rank bytes and sends after
    each level."""

    def __init__(self, comm):
        super().__init__()
        self.comm, self.bytes, self.sends = comm, [], []

    def append(self, ms):
        super().append(ms)
        self.bytes.append(self.comm.bytes_sent.copy())
        self.sends.append(self.comm.sends.copy())


def roofline_bfs(parts, cfg, root, dev):
    """Phase 3d(b): the dry run's BFS cell at phase 7's real partition (one
    dense top-down level's terms, ``launch.dryrun.bfs_level_terms``): its
    bytes and sends a rank equal the Communicator's count at every level
    of phase 7's first root (the butterfly's levels are all dense); the
    modeled memory term (the level's least kernel bytes over the HBM rate)
    against the measured ms a level."""
    import numpy as np

    from repro_torch.core import bfs, collectives
    from repro_torch.dist.sharding import SimMesh
    from repro_torch.launch import dryrun, hlo_stats

    pg = parts["pg"]
    mesh = SimMesh(pg.p)
    terms = dryrun.bfs_level_terms(pg, dataclasses.replace(cfg, mode="top_down"), mesh)
    comm = collectives.Communicator(mesh, dev)
    levels = LevelCounts(comm)
    fn = bfs.build_bfs_fn(pg, cfg, parts["layout"], device=dev)
    _, n_levels, _ = fn(parts["arrays"], root, comm, level_ms=levels)
    sent = np.diff(np.stack([np.zeros_like(comm.bytes_sent)] + levels.bytes), axis=0)
    sends = np.diff(np.stack([np.zeros_like(comm.sends)] + levels.sends), axis=0)
    if not (len(levels) == n_levels and (sent == terms["bytes_sent"]).all()
            and (sends == terms["sends"]).all()):
        raise AssertionError(f"3d(b): the BFS cell models {terms['bytes_sent']} B and "
                             f"{terms['sends']} sends a rank a level; phase 7's root {root} "
                             f"sent {sent[:, 0].tolist()} B and {sends[:, 0].tolist()}")
    model_ms = terms["least_bytes_total"] / hlo_stats.HBM_BW * 1e3
    ms = np.asarray(levels, dtype=np.float64)
    out = dict(root=root, levels=n_levels, bytes_per_level=terms["bytes_sent"],
               sends_per_level=terms["sends"], collectives=terms["collectives"],
               least_bytes=terms["least_bytes"], model_memory_ms=model_ms,
               model_collective_ms=terms["bytes_sent"] / hlo_stats.LINK_BW * 1e3,
               level_ms=ms.tolist(), level_ms_median=float(np.median(ms)),
               level_ms_max=float(ms.max()))
    log(f"  3d(b) root {root}: {n_levels} levels, each {terms['bytes_sent']:,} B and "
        f"{terms['sends']} sends a rank == the BFS cell's dense level at every level")
    log(f"  3d(b) a dense top-down level's least kernel bytes {terms['least_bytes_total']:.4g} "
        f"B (gather {terms['least_bytes']['gather']:.4g}, scatter "
        f"{terms['least_bytes']['scatter']:.4g}, merge {terms['least_bytes']['merge']:.4g}; "
        f"upper bounds where a bound reads values) = {model_ms:.3f} ms at the HBM rate; "
        f"measured a level (device synced each level): median {out['level_ms_median']:.3f} "
        f"ms, max {out['level_ms_max']:.3f} ms, all {', '.join(f'{x:.2f}' for x in ms)}")
    return out


def start_dryrun_cli(out_dir):
    """Phase 3d(c), started before the LM phases so that it overlaps them:
    ``python -m repro_torch.launch.dryrun`` for qwen3-1.7b's ``train_4k`` on
    the single-pod mesh, in a process of its own that sees no card (fake
    tensors, one thread)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH, "--shape",
           "train_4k", "--mesh", "single", "--out", out_dir]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_dryrun_cli(proc, out_dir, timeout_s=600):
    """Phase 3d(c): the CLI's exit code 0, its row ``ok`` from fake tensors,
    and ``summary``'s tables of it."""
    from repro_torch.launch import summary

    t0 = time.perf_counter()
    try:
        text, _ = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    waited = time.perf_counter() - t0
    rows = summary.load(out_dir, "single")
    if proc.returncode != 0 or len(rows) != 1 or rows[0]["status"] != "ok" \
            or rows[0]["source"] != "fake":
        raise AssertionError(f"3d(c): the dry-run CLI exited {proc.returncode}: {text[-2000:]}")
    row = rows[0]
    for line in text.strip().splitlines():
        log(f"  3d(c) dryrun: {line}")
    for line in (summary.dryrun_table(rows) + "\n" + summary.roofline_table(rows)).splitlines():
        log(f"  3d(c) summary: {line}")
    log(f"  3d(c) waited {waited:.1f} s for the CLI after the phases it overlapped")
    return dict(row={k: v for k, v in row.items() if k != "flops_by_op"}, waited_s=waited)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def sync_compare(model, batch, dev):
    """(b), the comparison: each rank's 4 rows in 4 one-row microbatches
    against ``_grads_of`` over the 16 rows in 16 microbatches (the same
    per-row bfloat16 gradients, summed in float32 in another order),
    deterministic algorithms on. Every method gives every rank the
    one-device gradient within ``SYNC_REL_TOL`` per leaf, the loss agrees,
    fanout 2's ranks are bit-identical, each rank's bytes equal the byte
    model; the int8 wire within its bound at about a quarter of the bytes.
    Its buffers are this function's locals, freed when it returns."""
    import torch

    from repro_torch.core import butterfly, collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.models import api
    from repro_torch.train import step as step_mod

    p, rows = TRAIN_RANKS, TRAIN_BATCH // TRAIN_RANKS
    loss_fn = api.train_loss_fn(model.cfg)
    torch.cuda.reset_peak_memory_stats()
    res = {"ranks": p, "rows_per_rank": rows}
    with deterministic():
        t0 = time.perf_counter()
        stacks = step_mod.grad_buffers(model, rows, torch.float32, lead=(p,))
        losses = [step_mod._grads_of(loss_fn, model, shard, rows, torch.float32,
                                     out=shd.tree_map(lambda s, r=r: s[r], stacks))[0]
                  for r, shard in enumerate(step_mod._split_batch(batch, p))]
        rank_loss = torch.stack(losses).sum() / p
        one_loss, one = step_mod._grads_of(loss_fn, model, batch, TRAIN_BATCH, torch.float32)
        torch.cuda.synchronize()
        res["grads_s"] = time.perf_counter() - t0
    leaves = list(shd.sorted_leaves(stacks))
    res["loss_rel_err"] = abs(float(rank_loss) - float(one_loss)) / abs(float(one_loss))
    if not res["loss_rel_err"] <= SYNC_REL_TOL:
        raise AssertionError(f"sync: rank loss {float(rank_loss)} != one-device "
                             f"{float(one_loss)}")
    n_elems = [g[0].numel() for _, g in leaves]
    res["n_elems"] = n_elems
    res["grad_bytes_per_rank"] = 4 * sum(n_elems)
    log(f"  {p} ranks x {rows} rows ({rows} one-row microbatches each) and the one-device "
        f"gradient ({TRAIN_BATCH} one-row microbatches) in {res['grads_s']:.1f} s; loss "
        f"{float(rank_loss):.6f} vs {float(one_loss):.6f} (rel {res['loss_rel_err']:.2e}); "
        f"{len(leaves)} leaves, {res['grad_bytes_per_rank'] / 1e9:.3f} GB float32 a rank")
    for method, fanout in SYNC_CASES + (("int8", 2),):
        comm = collectives.Communicator(p, dev)
        worst, spread, excess = 0.0, 0.0, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for path, g in leaves:
            want = shd.tree_get(one, path)
            if method == "int8":
                synced = collectives.sync_leaf_int8(g, comm, fanout=fanout)
                depth = len(comm.schedule(fanout).rounds)
                bound = depth * g.abs().sum(0).max() / 127
                excess = max(excess, float((synced * p - g.sum(0)).abs().max() / bound))
            else:
                synced = collectives.sync_leaf(g, comm, method=method, fanout=fanout)
            for r in range(p):
                worst = max(worst, rel_err(synced[r], want))
                if r:
                    spread = max(spread, float((synced[r] - synced[0]).abs().max()))
            del synced
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        label = f"{method} fanout {fanout}"
        model_bytes = sum(collectives.grad_sync_bytes(
            "butterfly" if method == "int8" else method, p, fanout, n, 4,
            "int8" if method == "int8" else None) for n in n_elems)
        if not (comm.bytes_sent == model_bytes).all():
            raise AssertionError(f"sync {label}: bytes {comm.bytes_sent} != model {model_bytes}")
        rec = dict(rel_err=worst, rank_spread=spread, bytes_per_rank=model_bytes, s=sync_s)
        if method == "int8":
            f32 = sum(butterfly.bytes_per_node_allreduce(p, fanout, 4 * n) for n in n_elems)
            rec.update(bound_share=excess, f32_bytes=f32, byte_ratio=model_bytes / f32)
            if not excess <= 1.0:
                raise AssertionError(f"sync int8: error {excess:.3f} of depth x max|g|/127")
            log(f"  int8 wire (butterfly fanout 2): error {excess:.3f} of its bound depth x "
                f"max|g|/127, rel {worst:.2e} of the one-device gradient; "
                f"{model_bytes / 1e9:.3f} GB a rank = the model, {rec['byte_ratio']:.4f} of "
                f"float32's; {sync_s:.2f} s")
        else:
            if not worst <= SYNC_REL_TOL:
                raise AssertionError(f"sync {label}: rel err {worst:.3e} > {SYNC_REL_TOL}")
            if method in ("butterfly", "rabenseifner") and fanout == 2 and spread != 0.0:
                raise AssertionError(f"sync {label}: ranks differ by {spread}")
            log(f"  {label:22s} rel err {worst:.2e} <= {SYNC_REL_TOL:g}; ranks differ by "
                f"{spread:.3e}; {model_bytes / 1e9:.3f} GB a rank = the byte model; "
                f"{sync_s:.2f} s")
        res[label] = rec
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def sync_full_width(model, dev):
    """(b) The gradient sync at full width on ``TRAIN_RANKS`` simulated ranks
    (:func:`sync_compare`), then one full butterfly step with AdamW from
    fresh moments, after the comparison's buffers are freed."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.train import optim, step as step_mod

    p, rows = TRAIN_RANKS, TRAIN_BATCH // TRAIN_RANKS
    batch = device_batch(SyntheticLM(model.cfg, TRAIN_BATCH, TRAIN_SEQ), TRAIN_STEPS + 1, dev)
    res = sync_compare(model, batch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = shd.SimMesh(p)
    fn = step_mod.build_train_step_butterfly(model.cfg, mesh, shd.rules_for_mesh(mesh),
                                             method="butterfly", fanout=2,
                                             microbatches=rows, lr_kw=TRAIN_LR)
    state = optim.ADAMW.init(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with deterministic():
        model, state, m = fn(model, state, batch, TRAIN_STEPS + 1)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    want_bytes = sum(collectives.grad_sync_bytes("butterfly", p, 2, n, 4)
                     for n in res["n_elems"])
    loss = float(m["loss"])
    if not (loss == loss and abs(loss) < 1e4 and float(m["rank_spread"]) == 0.0
            and m["bytes_per_rank"] == want_bytes):
        raise AssertionError(f"butterfly step: {m}")
    res["step"] = dict(loss=loss, grad_norm=float(m["grad_norm"]), s=step_s,
                       bytes_per_rank=m["bytes_per_rank"],
                       peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  one butterfly step (P {p}, fanout 2, AdamW): loss {loss:.4f}, ranks identical, "
        f"{m['bytes_per_rank'] / 1e9:.3f} GB a rank = the model; {step_s:.2f} s; peak "
        f"{res['step']['peak_bytes'] / 1e9:.2f} GB (the comparison's "
        f"{res['peak_bytes'] / 1e9:.2f} GB)")
    return res


def restart_check(dev, seed, tmp=None, cfg=None, shape=None, plan=None, mesh=None,
                  rules=None, async_save=True, restart=True):
    """(c) ``cfg`` (qwen3-1.7b's widths cut to ``RESTART_LAYERS`` layers by
    default) on ``shape`` = (rows, tokens, microbatches), sharded over
    ``mesh`` with ``rules`` where given, deterministic algorithms on:
    ``plan`` = (steps, fail at, checkpoint every) (``RESTART_STEPS``,
    ``RESTART_FAIL``, ``RESTART_EVERY`` by default): the steps uninterrupted
    against a run that fails and restarts from its last checkpoint (written
    synchronously); the final parameters and optimizer state equal bit for
    bit (``restart=False``: the uninterrupted run alone, its losses and step
    times). Then, where ``async_save``, the blocking host copy of an async
    save against its write. The checkpoints live in ``tmp/ck`` (the async
    save's, of the final step, is phase 3c's to restore; the last
    synchronous one otherwise); without ``tmp``, in a temporary directory
    removed after."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.dist import sharding as shd
    from repro_torch.models import api
    from repro_torch.train import loop

    cfg = cfg or dataclasses.replace(configs.get_config(LM_ARCH), n_layers=RESTART_LAYERS)
    rows_n, seq, mb = shape or (TRAIN_BATCH, TRAIN_SEQ, cfg.train_microbatches)
    n_steps, fail, every = plan or (RESTART_STEPS, RESTART_FAIL, RESTART_EVERY)
    kw = dict(n_steps=n_steps, microbatches=mb, lr_kw=TRAIN_LR, log_every=100)
    on = dict(device=dev, mesh=mesh, rules=rules)
    own = tmp is None
    tmp = tempfile.mkdtemp(prefix="repro_torch_restart_") if own else tmp
    ck = os.path.join(tmp, "ck")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": api.param_counts(cfg)["total"],
           "mesh": None if mesh is None else (mesh.sizes, mesh.axis_names),
           "fsdp": bool(rules is not None and rules.fsdp), "plan": (n_steps, fail, every)}
    try:
        with deterministic():
            rows = []
            t0 = time.perf_counter()
            ref = loop.train(cfg, rows_n, seq, loop.LoopConfig(**kw), seed=seed,
                             on_metrics=lambda s, m: rows.append(m["step_time"]), **on)
            res["uninterrupted_s"] = time.perf_counter() - t0
            res["step_s"] = rows
            want_p = api.to_reference(ref["params"])
            want_o = {k: api.to_numpy(v) for k, v in shd.sorted_leaves(ref["opt_state"])}
            want_losses = ref["losses"]
            del ref
            if not restart:
                res["losses"] = want_losses
                log(f"  {cfg.name} cut to {cfg.n_layers} layers ({res['params']:,} "
                    f"parameters, {cfg.optimizer}), {rows_n} x {seq} tokens in {mb} "
                    f"microbatches: {n_steps} steps through train.loop.train, losses "
                    f"{', '.join(f'{x:.4f}' for x in want_losses)}, a step "
                    f"{', '.join(f'{x * 1e3:.1f}' for x in rows)} ms; "
                    f"{res['uninterrupted_s']:.1f} s")
                return res
            try:
                loop.train(cfg, rows_n, seq,
                           loop.LoopConfig(ckpt_dir=ck, ckpt_every=every,
                                           fail_at_step=fail, async_ckpt=False, **kw),
                           seed=seed, **on)
                raise AssertionError("restart: the run did not fail")
            except loop.SimulatedFailure:
                pass
            if ckpt.latest_step(ck) != every:
                raise AssertionError(f"restart: latest checkpoint {ckpt.latest_step(ck)}")
            t0 = time.perf_counter()
            out = loop.train(cfg, rows_n, seq,
                             loop.LoopConfig(ckpt_dir=ck, ckpt_every=every,
                                             async_ckpt=False, **kw), seed=seed, **on)
            res["resumed_run_s"] = time.perf_counter() - t0
        got_p = api.to_reference(out["params"])
        same = all(np.array_equal(a.view(np.int16) if a.dtype.kind == "V" else a,
                                  b.view(np.int16) if b.dtype.kind == "V" else b)
                   for (_, a), (_, b) in zip(shd.sorted_leaves(got_p),
                                             shd.sorted_leaves(want_p)))
        same_o = all(np.array_equal(api.to_numpy(v), want_o[k])
                     for k, v in shd.sorted_leaves(out["opt_state"]))
        if not (same and same_o and out["losses"] == want_losses[every:]):
            raise AssertionError(f"{cfg.name} restart: params equal {same}, optimizer state "
                                 f"equal {same_o}, losses {out['losses']} vs {want_losses}")
        res.update(losses=want_losses,
                   ckpt_bytes=os.path.getsize(os.path.join(ck, "arrays.npz")))
        where = "" if mesh is None else (f" on {dict(zip(mesh.axis_names, mesh.sizes))}"
                                         f"{' with FSDP rules' if res['fsdp'] else ''}")
        log(f"  {cfg.name} cut to {cfg.n_layers} layers ({res['params']:,} parameters, "
            f"{cfg.optimizer}){where}, {rows_n} x {seq} tokens: {n_steps} steps == failed at "
            f"step {fail}, restarted from the step-{every} checkpoint "
            f"({res['ckpt_bytes'] / 1e9:.3f} GB): parameters, optimizer state and losses "
            f"equal bit for bit; losses {', '.join(f'{x:.4f}' for x in want_losses)}; "
            f"uninterrupted {res['uninterrupted_s']:.1f} s, resumed {res['resumed_run_s']:.1f} s")
        if async_save:
            # an async save: the blocking copy to the host, then the writer thread
            t0 = time.perf_counter()
            writer = ckpt.save(ck, n_steps, {"params": out["params"],
                                             "opt_state": out["opt_state"]}, async_=True)
            copy_s = time.perf_counter() - t0
            writer.join()
            write_s = time.perf_counter() - t0 - copy_s
            size = os.path.getsize(os.path.join(ck, "arrays.npz"))
            res.update(copy_s=copy_s, write_s=write_s, ckpt_bytes=size)
            log(f"  async save of {size / 1e9:.3f} GB: blocking copy {copy_s:.2f} s, then the "
                f"write {write_s:.2f} s on its thread")
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    return res


def adam_close(label, got, want, grads, lr_sum, tol):
    """Parameters after AdamW steps (reference trees of float32 arrays)
    within ``tol`` (rtol = atol), except where a step's gradient (``grads``:
    one tree a step) was nonzero and under ``ADAM_ILL_CONDITIONED`` in
    magnitude: there within ``2 lr_sum``, the most an update bounded by 1
    moves a parameter (those elements must be under 1 % of the model; a
    zero gradient, a row no token of the batch reaches, moves alike
    anywhere)."""
    import numpy as np

    from repro_torch.dist.sharding import sorted_leaves

    ill = {}
    for tree in grads:
        for path, g in sorted_leaves(tree):
            g = g.abs().cpu().numpy()
            small = (g < ADAM_ILL_CONDITIONED) & (g > 0)
            ill[path] = small if path not in ill else ill[path] | small
    worst, n_ill, n = 0.0, 0, 0
    for (path, a), (_, b) in zip(sorted_leaves(got), sorted_leaves(want)):
        err, m = np.abs(a - b), ill[path]
        if (err[m] > 2 * lr_sum).any():
            raise AssertionError(f"{label} {'/'.join(path)}: {int(m.sum())} ill-conditioned "
                                 f"elements, worst {err[m].max()}")
        share = float((err[~m] / (tol + tol * np.abs(b[~m]))).max()) if (~m).any() else 0.0
        if share > 1.0:
            raise AssertionError(f"{label} {'/'.join(path)}: outside {tol} ({share:.2f})")
        worst, n_ill, n = max(worst, share), n_ill + int(m.sum()), n + m.size
    if n_ill >= 0.01 * n:
        raise AssertionError(f"{label}: {n_ill} of {n} elements ill-conditioned")
    return dict(tol_share=worst, ill_conditioned=n_ill)


def train_card_vs_cpu(dev, seed):
    """(d) Every arch's reduced config, float32 with TF32 off: 2 steps of
    ``build_train_step`` (AdamW or the config's Adafactor) on the card
    against the port on the CPU from the same weights: the losses and the
    parameters within ``CARD_TRAIN_TOL``."""
    import copy

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    rows = {}
    with exact_float32():
        for arch in configs.ARCH_NAMES:
            cfg = configs.reduced(configs.get_config(arch))
            data = SyntheticLM(cfg, CARD_TRAIN_BATCH, CARD_TRAIN_SEQ)
            fn = step_mod.build_train_step(cfg, lr_kw=CARD_TRAIN_LR)
            opt = optim.get(cfg.optimizer)
            cpu = api.init_params(cfg, seed, device="cpu")
            card = copy.deepcopy(cpu).to(dev)
            cpu_state, card_state = opt.init(cpu), opt.init(card)
            grads, lr_sum, loss_err = [], 0.0, 0.0
            for s in (1, 2):
                cb, gb = device_batch(data, s, "cpu"), device_batch(data, s, dev)
                grads.append(step_mod._grads_of(api.train_loss_fn(cfg), cpu, cb, 1)[1])
                cpu, cpu_state, mc = fn(cpu, cpu_state, cb, s)
                card, card_state, mg = fn(card, card_state, gb, s)
                lr_sum += mc["lr"]
                loss_err = max(loss_err, abs(float(mg["loss"]) / float(mc["loss"]) - 1))
            if loss_err > CARD_TRAIN_TOL:
                raise AssertionError(f"{arch} train on the card: loss rel err {loss_err}")
            rows[arch] = dict(loss_rel_err=loss_err, optimizer=cfg.optimizer, **adam_close(
                f"{arch} train card against CPU", api.to_reference(card),
                api.to_reference(cpu), grads, lr_sum, CARD_TRAIN_TOL))
            log(f"  {arch:22s} {cfg.optimizer:9s} loss rel err {loss_err:.2e}; params "
                f"{rows[arch]['tol_share']:.3f} of {CARD_TRAIN_TOL:g} "
                f"({rows[arch]['ill_conditioned']} elements with a near-zero gradient held "
                f"to the update's bound)")
    return rows


def run_train(dev, seed, profile, tmp=None):
    """Phase 3b: the LM training path (module docstring, item 3b). The graph
    kernels are not on this path: their counts stay 0. The restart's
    checkpoints are written under ``tmp`` (a temporary directory by
    default)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli

    build.reset_launches()
    out = {}
    out["published"], model = train_published(dev, seed, profile)
    gc.collect()
    torch.cuda.empty_cache()
    out["sync"] = sync_full_width(model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["restart"] = restart_check(dev, seed, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced"] = train_card_vs_cpu(dev, seed)
    t0 = time.perf_counter()
    if train_cli.main(["--arch", LM_ARCH, "--smoke", "--steps", "3", "--device", dev.type]):
        raise AssertionError("launch.train --smoke failed")
    out["cli_s"] = time.perf_counter() - t0
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the training path launched graph kernels: {launched}")
    log(f"  launch.train --smoke on the card in {out['cli_s']:.1f} s; the training path "
        f"launched none of the four graph kernels")
    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The LM side's multi-device half (phase 3c)
# ---------------------------------------------------------------------------

# (a) the parameters placed on a (data 2, model 4) mesh of simulated devices
PLACE_MESH = ((2, 4), ("data", "model"))
# (b) phase 3b(c)'s checkpoint restored onto (data 2, model 4), and onto data
# 8 with fsdp (ZeRO-3: the embed dimension split 8 ways; without it data 8
# replicates every leaf)
RESTORE_MESHES = (("data 2 x model 4", (2, 4), ("data", "model"), False),
                  ("data 8, fsdp", (8,), ("data",), True))
# (c) GPipe of tests/test_pipeline.py's layer tanh(x @ W) at qwen3-1.7b's
# depth and width, float32 with TF32 off, on a (stage 4, data 1) mesh; the
# reference test's tolerances
GPIPE_STAGES, GPIPE_MICRO, GPIPE_ROWS, GPIPE_REPS = 4, 8, 1024, 3
GPIPE_FWD_TOL, GPIPE_GRAD_TOL = (2e-5, 2e-6), (5e-4, 5e-6)
# (d) the gradient sync over torch.distributed: gloo processes on the card,
# each with TRAIN_BATCH / DIST_WORLD rows of phase 3b's batch
DIST_WORLD, DIST_TIMEOUT_S = 4, 300
DIST_CASES = SYNC_CASES + (("int8", 2),)
CHECKSUM_CHUNK = 1 << 25


def block_slices(shape, spec, sizes, names, i):
    """Device ``i``'s block of a ``shape`` tensor under ``spec`` on the mesh
    ``sizes``/``names`` (row-major devices; a dimension split over axes
    ``(a, b)`` takes block ``coord_a * |b| + coord_b``): the JAX layout,
    written apart from the port's ``sharding.place``."""
    coords, rest = {}, i
    for name, n in reversed(list(zip(names, sizes))):
        coords[name], rest = rest % n, rest // n
    size = dict(zip(names, sizes))
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        k, parts = 0, 1
        for a in axes:
            k, parts = k * size[a] + coords[a], parts * size[a]
        out.append(slice(k * (n // parts), (k + 1) * (n // parts)))
    return tuple(out)


def bits(t):
    """``t``'s bit patterns as integers (bit-exact comparisons)."""
    import torch

    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}[
        t.element_size()])


def check_shards(label, full, shards, spec, sizes, names):
    """Every device's shard equal bit for bit to its block of ``full``."""
    for i in range(shards.shape[0]):
        if not torch_equal(bits(shards[i]), bits(full[block_slices(full.shape, spec, sizes,
                                                                     names, i)])):
            raise AssertionError(f"{label}: device {i}'s shard is not its block ({spec})")


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def spec_bytes(structs):
    """(total bytes, bytes of leaves split on some axis, one device's bytes)
    of a tree of ``ShardStruct``."""
    import math

    from repro_torch.dist.sharding import sorted_leaves

    total = split = device = 0
    for _, st in sorted_leaves(structs):
        n = math.prod(st.shape) * st.dtype.itemsize
        total += n
        split += n if any(e is not None for e in st.spec) else 0
        device += math.prod(st.shard_shape) * st.dtype.itemsize
    return total, split, device


def placement(dev, seed):
    """(a) qwen3-1.7b's parameter, optimizer-state and input specs at its
    published size on both production meshes (descriptors only), then its
    seeded bfloat16 parameters placed on a (data 2, model 4) mesh on the
    card: every shard its block, the gathered tree the parameters bit for
    bit."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.train import optim

    cfg = configs.get_config(LM_ARCH)
    pdefs = api.param_defs(cfg)
    res = {}
    for label, mesh in (("production", mesh_mod.make_production_mesh()),
                        ("multi_pod", mesh_mod.make_production_mesh(multi_pod=True))):
        rules = shd.rules_for_mesh(mesh, cfg.fsdp)
        rec = {}
        for what, defs, dtype in (
                ("params", pdefs, cfg.param_dtype),
                ("opt_state", optim.get(cfg.optimizer).state_defs(pdefs), "float32"),
                ("inputs", api.input_defs(cfg, SHAPES["train_4k"]), cfg.compute_dtype)):
            total, split, device = spec_bytes(shd.tree_structs(defs, dtype, rules, mesh))
            rec[what] = dict(bytes=total, split_bytes=split, device_bytes=device,
                             split_share=split / total)
        res[label] = rec
        p = rec["params"]
        log(f"  {label} mesh {mesh.shape}: {p['split_share']:.1%} of the parameter bytes "
            f"({p['split_bytes'] / 1e9:.3f} of {p['bytes'] / 1e9:.3f} GB) split, "
            f"{p['device_bytes'] / 1e9:.3f} GB a device; optimizer state "
            f"{rec['opt_state']['split_share']:.1%} split, "
            f"{rec['opt_state']['device_bytes'] / 1e9:.3f} GB a device; train_4k inputs "
            f"{rec['inputs']['device_bytes'] / 1e6:.1f} MB a device")
    sizes, names = PLACE_MESH
    mesh = shd.SimMesh(sizes, names)
    rules = shd.rules_for_mesh(mesh, cfg.fsdp)
    model = api.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    place_s, placed, n_split = 0.0, 0, 0
    for path, lead, prms in api.param_leaves(model):
        full = api.stack_leaf(lead, prms)
        spec = shd.spec_for(shd.tree_get(pdefs, path), rules, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = shd.place(full, spec, mesh)
        torch.cuda.synchronize()
        place_s += time.perf_counter() - t0
        check_shards(f"place {'/'.join(path)}", full, shards, spec, sizes, names)
        if not torch_equal(bits(shd.gather(shards, spec, mesh)), bits(full)):
            raise AssertionError(f"place {'/'.join(path)}: gathered != the parameter")
        placed += shards.numel() * shards.element_size()
        n_split += any(e is not None for e in spec)
        del full, shards
    res["placed"] = dict(mesh=dict(zip(names, sizes)), leaves=len(api.param_leaves(model)),
                         split_leaves=n_split, shard_bytes=placed, place_s=place_s,
                         peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  {cfg.name} ({api.param_counts(cfg)['total']:,} parameters, bfloat16) placed on "
        f"data 2 x model 4: {n_split} of {res['placed']['leaves']} leaves split, "
        f"{placed / 1e9:.3f} GB of shards in {place_s:.2f} s; every shard its block, the "
        f"gathered tree the parameters bit for bit; peak {res['placed']['peak_bytes'] / 1e9:.2f} GB")
    del model
    return res


def elastic_restore(dev, ck, cfg=None, meshes=RESTORE_MESHES):
    """(b) phase 3b(c)'s checkpoint (2 layers, the final step's parameters
    and AdamW moments; or ``cfg``'s) restored onto each of ``meshes`` by
    ``ckpt.restore(mesh=, pspecs=)``: every shard equal bit for bit to its
    block of the saved array (read from the file apart from the restore),
    the model template filled with the saved parameters; the restore's
    seconds and peak memory."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.dist import sharding as shd
    from repro_torch.models import api
    from repro_torch.train import optim

    cfg = cfg or dataclasses.replace(configs.get_config(LM_ARCH), n_layers=RESTART_LAYERS)
    opt = optim.get(cfg.optimizer)
    pdefs = api.param_defs(cfg)
    sdefs = opt.state_defs(pdefs)
    with np.load(os.path.join(ck, "arrays.npz")) as data:
        saved = {k: data[k] for k in data.files}
    res = {"ckpt_bytes": os.path.getsize(os.path.join(ck, "arrays.npz")),
           "step": ckpt.latest_step(ck)}
    for label, sizes, names, fsdp in meshes:
        mesh = shd.SimMesh(sizes, names)
        rules = shd.rules_for_mesh(mesh, fsdp)
        pspecs = {"params": shd.tree_pspecs(pdefs, rules, mesh),
                  "opt_state": shd.tree_pspecs(sdefs, rules, mesh)}
        template = api.build_model(cfg, dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step, trees = ckpt.restore(ck, {"params": template, "opt_state": sdefs}, mesh=mesh,
                                   pspecs=pspecs, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        shard_bytes, n_split = 0, 0
        for name in ("params", "opt_state"):
            for path, shards in shd.sorted_leaves(trees[name]):
                full = api.from_numpy(saved["/".join((name,) + path)]).to(dev)
                spec = shd.tree_get(pspecs[name], path)
                check_shards(f"restore {label} {name}/{'/'.join(path)}", full, shards, spec,
                             sizes, names)
                shard_bytes += shards.numel() * shards.element_size()
                n_split += any(e is not None for e in spec)
        for path, lead, prms in api.param_leaves(template):
            want = api.from_numpy(saved["/".join(("params",) + path)]).to(dev)
            if not torch_equal(bits(api.stack_leaf(lead, prms)), bits(want)):
                raise AssertionError(f"restore {label}: the model's {'/'.join(path)} differs")
        res[label] = dict(step=step, restore_s=restore_s, peak_bytes=peak,
                          shard_bytes=shard_bytes, split_leaves=n_split)
        log(f"  restored the {res['ckpt_bytes'] / 1e9:.3f} GB checkpoint (step {step}) onto "
            f"{label}: {shard_bytes / 1e9:.3f} GB of shards, {n_split} leaves split, every "
            f"shard its block of the saved array bit for bit, the model filled; "
            f"{restore_s:.2f} s, peak {peak / 1e9:.2f} GB over what was held")
        del trees, template
    return res


def gpipe_stage(w, x):
    import torch

    for layer in w:
        x = torch.tanh(x @ layer)
    return x


def gpipe_sequential(stacked, mbs, data=1):
    """The sequential stack over each microbatch, its rows in ``data``
    blocks as the data ranks hold them (the GEMMs at the ranks' shapes)."""
    import torch

    return torch.stack([torch.cat([gpipe_stage(stacked, b) for b in x.chunk(data)])
                        for x in mbs])


def wall_ms(fn, reps):
    """Median host ms of ``fn()`` ending in a synchronize, after a warm-up."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def gpipe(dev, seed, data=1):
    """(c) GPipe on a (stage 4, data ``data``) mesh: ``[28, 2048, 2048]``
    float32 layers ``tanh(x @ W)`` in 4 stages of 7, 8 microbatches of
    (1024, 2048), each microbatch's rows split over the data ranks, TF32
    off: the forward against the sequential stack on the same row blocks
    (with data 2 a H100 put the full rows' GEMMs 2.7e-6 from the blocks'
    at the 28th layer), the weight gradient of
    ``sum(out ** 2)`` against the sequential one (the reference test's
    tolerances), ``M + S - 1`` handoffs from every rank of each stage but
    the last of one block (its rows) each, and both timed."""
    import torch

    from repro_torch import configs
    from repro_torch.core.collectives import Communicator
    from repro_torch.dist import pipeline
    from repro_torch.dist.sharding import SimMesh

    cfg = configs.get_config(LM_ARCH)
    n_layers, d = cfg.n_layers, cfg.d_model
    s, m, rows = GPIPE_STAGES, GPIPE_MICRO, GPIPE_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stacked = torch.randn((n_layers, d, d), generator=gen, device=dev) * d ** -0.5
    mbs = torch.randn((m, rows, d), generator=gen, device=dev)
    mesh = SimMesh((s, data), ("stage", "data"))
    apply = pipeline.build_pipelined_apply(mesh, gpipe_stage)
    res = dict(layers=n_layers, d=d, stages=s, data=data, microbatches=m, rows=rows)
    torch.cuda.reset_peak_memory_stats()
    with exact_float32():
        with torch.no_grad():
            comm = Communicator(mesh, dev)
            got = apply(stacked, mbs, comm)
            want = gpipe_sequential(stacked, mbs, data)
            res["forward"] = check_close("gpipe forward", got, want, *GPIPE_FWD_TOL)
            res["forward"]["bit_equal"] = torch_equal(bits(got), bits(want))
            del got, want
            ticks = m + s - 1
            want_bytes = [ticks * rows // data * d * 4] * ((s - 1) * data) + [0] * data
            if comm.sends.tolist() != [ticks] * ((s - 1) * data) + [0] * data or \
                    comm.bytes_sent.tolist() != want_bytes:
                raise AssertionError(f"gpipe: sends {comm.sends}, bytes {comm.bytes_sent}, "
                                     f"expected {ticks} ticks of {want_bytes}")
            res.update(ticks=ticks, stage_bytes=comm.bytes_sent.tolist())
            res["pipelined_ms"] = wall_ms(lambda: apply(stacked, mbs), GPIPE_REPS)
            res["sequential_ms"] = wall_ms(lambda: gpipe_sequential(stacked, mbs, data),
                                           GPIPE_REPS)
        w = stacked.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (g_pipe,) = torch.autograd.grad((apply(w, mbs) ** 2).sum(), w)
        torch.cuda.synchronize()
        res["pipelined_grad_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        (g_seq,) = torch.autograd.grad((gpipe_sequential(w, mbs, data) ** 2).sum(), w)
        torch.cuda.synchronize()
        res["sequential_grad_ms"] = (time.perf_counter() - t0) * 1e3
        res["grad"] = check_close("gpipe weight gradient", g_pipe, g_seq, *GPIPE_GRAD_TOL)
        res["grad"]["bit_equal"] = torch_equal(bits(g_pipe), bits(g_seq))
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["bubble_ratio"] = res["pipelined_ms"] / res["sequential_ms"]
    log(f"  GPipe [{n_layers}, {d}, {d}] float32 in {s} stages of {n_layers // s} x data "
        f"{data}, {m} "
        f"microbatches of ({rows}, {d}): forward max abs err {res['forward']['max_abs_err']:.3e} "
        f"({res['forward']['tol_share']:.3f} of rtol 2e-5 atol 2e-6; bit-equal "
        f"{res['forward']['bit_equal']}); weight gradient max abs err "
        f"{res['grad']['max_abs_err']:.3e} ({res['grad']['tol_share']:.3f} of rtol 5e-4 atol "
        f"5e-6; bit-equal {res['grad']['bit_equal']})")
    log(f"  {ticks} handoff ticks, {want_bytes[0]:,} bytes from each rank of stages "
        f"0-{s - 2}, none from the last; forward pipelined {res['pipelined_ms']:.1f} ms against sequential "
        f"{res['sequential_ms']:.1f} ms ({res['bubble_ratio']:.3f}x; (M + S - 1) / M = "
        f"{ticks / m:.3f}); with the gradient {res['pipelined_grad_ms']:.1f} against "
        f"{res['sequential_grad_ms']:.1f} ms; peak {res['peak_bytes'] / 1e9:.2f} GB")
    return res


def bits_checksum(t) -> int:
    """A position-weighted sum of ``t``'s bit patterns modulo 2^64, on its
    device in chunks: equal tensors give equal sums, and a tensor that
    differs in any bit almost surely does not."""
    import torch

    flat = bits(t.detach().contiguous()).reshape(-1)
    total = 0
    for lo in range(0, flat.numel(), CHECKSUM_CHUNK):
        part = flat[lo:lo + CHECKSUM_CHUNK].to(torch.int64)
        w = torch.arange(lo + 1, lo + 1 + part.numel(), device=t.device, dtype=torch.int64)
        total += int((part * w.mul_(0x7F4A7C15)).sum())
    return total % (1 << 64)


# The processes of phases 3c(d) and 3e(d) share one card and reach their
# peaks together (each step's collectives keep them in step); in fixed
# segments each holds more than it allocates, and 3c(d)'s four filled the
# card at its butterfly step.  Expandable segments keep what each process
# holds close to what it allocates (``CardWatch`` reads the card's use).
CHILD_ALLOC_CONF = "expandable_segments:True"


def run_children(fn, world, args, backend):
    """``process.run_group`` of ``fn`` with the deadline ``DIST_TIMEOUT_S``;
    under gloo (every process on one card) the children's allocator set to
    ``CHILD_ALLOC_CONF`` unless ``PYTORCH_CUDA_ALLOC_CONF`` is set already (a
    spawned child reads it at start; this process's allocator is set up
    already and keeps its own).  Under nccl each process has a card."""
    from repro_torch.dist import process

    key = "PYTORCH_CUDA_ALLOC_CONF"
    mine = backend == "gloo" and key not in os.environ
    if mine:
        os.environ[key] = CHILD_ALLOC_CONF
    try:
        return process.run_group(fn, world, args, timeout_s=DIST_TIMEOUT_S, backend=backend)
    finally:
        if mine:
            del os.environ[key]


def dist_sync_leaf(g, comm, method, fanout):
    from repro_torch.core import collectives

    if method == "int8":
        return collectives.sync_leaf_int8(g, comm, fanout=fanout)
    return collectives.sync_leaf(g, comm, method=method, fanout=fanout)


def dist_child(rank, world, out_dir, job):
    """One process of (d), on ``job["device"]`` with ``world - 1`` others in
    a ``job["backend"]`` group (nccl: on card ``rank``). Each builds
    ``job["cfg"]`` (the 2-layer qwen3-1.7b cut) from ``job["seed"]``,
    computes the gradient of its rows of phase 3b's batch (one-row
    microbatches, deterministic algorithms) and syncs it by every method of
    ``DIST_CASES`` through a ``DistCommunicator``, timed. Rank 0 also
    computes every rank's gradient and syncs them on the simulated
    ``Communicator``; each rank's result is held to the simulated rank's
    bit for bit by checksums, and where a checksum differs the rank sends
    the leaf to rank 0, which holds it within ``SYNC_REL_TOL``. Then one
    butterfly train step a process against rank 0's simulated-rank step,
    parameters and moments by checksums. Writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.process import DistCommunicator
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    t_start = time.perf_counter()
    nccl = job["backend"] == "nccl"
    dev = torch.device("cuda", rank) if nccl else torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    def synchronize():
        if cuda:
            torch.cuda.synchronize(dev)

    build.reset_launches()
    cfg, seed, step_idx = job["cfg"], job["seed"], job["step"]
    model = api.init_params(cfg, seed, device=dev)
    batch = device_batch(SyntheticLM(cfg, job["batch"], job["seq"]), step_idx, dev)
    rows = job["batch"] // world
    shards = step_mod._split_batch(batch, world)
    loss_fn = api.train_loss_fn(cfg)
    res = {"rank": rank, "methods": {}}
    with deterministic():
        mine = step_mod.grad_buffers(model, rows, torch.float32, lead=(1,))
        step_mod._grads_of(loss_fn, model, shards[rank], rows, torch.float32,
                           out=shd.tree_map(lambda s: s[0], mine))
        stacks = None
        if rank == 0:  # every rank's gradient, as each computes its own
            stacks = step_mod.grad_buffers(model, rows, torch.float32, lead=(world,))
            for path, g in shd.sorted_leaves(mine):
                shd.tree_get(stacks, path)[0].copy_(g[0])
            for r in range(1, world):
                step_mod._grads_of(loss_fn, model, shards[r], rows, torch.float32,
                                   out=shd.tree_map(lambda s, r=r: s[r], stacks))
    synchronize()
    res["setup_s"] = time.perf_counter() - t_start
    leaves = list(shd.sorted_leaves(mine))
    res["n_elems"] = [g[0].numel() for _, g in leaves]
    # one small all-gather first: a backend opens each pair's connection at
    # its first message, which would otherwise fall in the first method's time
    dist_sync_leaf(torch.zeros((1, 8), device=dev), DistCommunicator(dev), "xla_psum", 2)
    for method, fanout in DIST_CASES:
        label = f"{method} fanout {fanout}"
        comm = DistCommunicator(dev)
        dist.barrier()
        synchronize()
        t0 = time.perf_counter()
        synced = [dist_sync_leaf(g, comm, method, fanout) for _, g in leaves]
        synchronize()
        sync_s = time.perf_counter() - t0
        sums = [bits_checksum(x[0]) for x in synced]
        if cuda:  # give the sync's buffers back while rank 0 runs the simulated one
            torch.cuda.empty_cache()
        rec = dict(s=sync_s, stage_s=comm.stage_s, wire_s=comm.wire_s,
                   bytes=int(comm.bytes_sent[0]), sends=int(comm.sends[0]))
        gathered = [None] * world
        dist.all_gather_object(gathered, (sums, rec["bytes"]))
        mismatched = []
        if rank == 0:
            sim = collectives.Communicator(world, dev)
            for i, (path, _) in enumerate(leaves):
                out = dist_sync_leaf(shd.tree_get(stacks, path), sim, method, fanout)
                for r in range(world):
                    if gathered[r][0][i] != bits_checksum(out[r]):
                        mismatched.append((i, r))
                del out
            model_bytes = sum(collectives.grad_sync_bytes(
                "butterfly" if method == "int8" else method, world, fanout, n, 4,
                "int8" if method == "int8" else None) for n in res["n_elems"])
            if any(b != model_bytes or b != sim.bytes_sent[r]
                   for r, (_, b) in enumerate(gathered)):
                raise AssertionError(f"dist {label}: bytes {[b for _, b in gathered]}, "
                                     f"simulated {sim.bytes_sent}, model {model_bytes}")
            rec["model_bytes"] = model_bytes
        box = [mismatched]
        dist.broadcast_object_list(box, src=0)
        worst = 0.0
        wire = dev if nccl else torch.device("cpu")  # what the backend carries
        for i, r in box[0]:
            path = leaves[i][0]
            if rank == r and r != 0:
                dist.send(synced[i][0].to(wire), dst=0)
            if rank == 0:
                got = synced[i][0].to(wire) if r == 0 else torch.empty(
                    synced[i][0].shape, dtype=synced[i][0].dtype, device=wire)
                if r != 0:
                    dist.recv(got, src=r)
                want = dist_sync_leaf(shd.tree_get(stacks, path),
                                      collectives.Communicator(world, dev), method, fanout)[r]
                worst = max(worst, rel_err(got.to(dev), want))
        if rank == 0:
            rec.update(bit_equal=not box[0], mismatched=len(box[0]), rel_err=worst)
            if worst > SYNC_REL_TOL:
                raise AssertionError(f"dist {label}: rel err {worst:.3e} > {SYNC_REL_TOL}")
        res["methods"][label] = rec
        del synced
        if cuda:
            torch.cuda.empty_cache()
    del stacks, mine, leaves, shards  # the step's peak is the four processes' at once
    if cuda:
        torch.cuda.empty_cache()
    # one butterfly train step a process, against rank 0's simulated-rank step
    mesh = shd.SimMesh(world)
    rules = shd.rules_for_mesh(mesh)
    kw = dict(method="butterfly", fanout=2, microbatches=rows, lr_kw=job["lr_kw"])
    comm = DistCommunicator(dev)
    fn = step_mod.build_train_step_butterfly(cfg, mesh, rules, comm=comm, **kw)
    state = optim.ADAMW.init(model)
    dist.barrier()
    synchronize()
    t0 = time.perf_counter()
    with deterministic():
        model, state, m = fn(model, state, batch, step_idx)
    synchronize()
    res["step"] = dict(s=time.perf_counter() - t0, loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]), bytes=m["bytes_per_rank"],
                       stage_s=comm.stage_s)

    def tree_sums(mdl, st):
        return ([bits_checksum(api.stack_leaf(lead, prms)) for _, lead, prms in
                 api.param_leaves(mdl)] + [bits_checksum(v) for _, v in shd.sorted_leaves(st)])

    sums = tree_sums(model, state)
    del model, state
    if cuda:
        torch.cuda.empty_cache()
    gathered = [None] * world
    if rank == 0:
        sim_model = api.init_params(cfg, seed, device=dev)
        sim_state = optim.ADAMW.init(sim_model)
        sim_fn = step_mod.build_train_step_butterfly(cfg, mesh, rules, **kw)
        with deterministic():
            sim_model, sim_state, sm = sim_fn(sim_model, sim_state, batch, step_idx)
        want = tree_sums(sim_model, sim_state)
        res["step"].update(sim_loss=float(sm["loss"]), sim_bytes=sm["bytes_per_rank"],
                           sim_spread=float(sm["rank_spread"]))
        del sim_model, sim_state
    dist.all_gather_object(gathered, sums)
    if rank == 0:
        differ = [r for r in range(world) if gathered[r] != want]
        if differ or res["step"]["bytes"] != res["step"]["sim_bytes"]:
            raise AssertionError(f"dist step: ranks {differ} differ from the simulated step "
                                 f"{res['step']}")
    res["launches"] = {k: v for k, v in build.LAUNCHES.items() if v}
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res["peak_reserved"] = torch.cuda.max_memory_reserved(dev) if cuda else 0
    res["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=float)


def dist_sync(dev, seed, child=None, backend="gloo", world=DIST_WORLD):
    """(d) ``child`` (``dist_child``) in ``world`` processes of a ``backend``
    group (gloo: all on the card ``dev``; nccl: one card each), joined with
    a deadline (a child that fails or hangs fails the phase, every process
    killed); then each method's seconds (the slowest rank's) with the host
    staging's share."""
    from repro_torch import configs

    job = dict(cfg=dataclasses.replace(configs.get_config(LM_ARCH), n_layers=RESTART_LAYERS),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, step=TRAIN_STEPS + 1, lr_kw=TRAIN_LR,
               seed=seed, device=str(dev), backend=backend)
    out_dir = tempfile.mkdtemp(prefix="repro_torch_dist_")
    try:
        t0 = time.perf_counter()
        codes = run_children(child or dist_child, world, (out_dir, job), backend)
        wall_s = time.perf_counter() - t0
        if any(codes):
            raise AssertionError(f"dist: the processes exited with {codes}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launched = [rk["launches"] for rk in ranks if rk["launches"]]
    if launched:
        raise AssertionError(f"dist: the processes launched graph kernels: {launched}")
    res = {"world": world, "backend": backend, "wall_s": wall_s,
           "setup_s": max(rk["setup_s"] for rk in ranks),
           "peak_bytes": [rk["peak_bytes"] for rk in ranks],
           "peak_reserved": [rk["peak_reserved"] for rk in ranks], "methods": {}}
    log(f"  {world} {backend} processes ({res['wall_s']:.1f} s in all; each "
        f"built the {RESTART_LAYERS}-layer cut and took its gradient in up to "
        f"{res['setup_s']:.1f} s; peaks {[round(p / 1e9, 2) for p in res['peak_bytes']]} GB, "
        f"reserved {[round(p / 1e9, 2) for p in res['peak_reserved']]} GB)")
    for label, rec in ranks[0]["methods"].items():
        s = max(rk["methods"][label]["s"] for rk in ranks)
        stage = max(rk["methods"][label]["stage_s"] for rk in ranks)
        res["methods"][label] = dict(rec, s_max=s, stage_share=stage / s)
        how = ("bit for bit" if rec["bit_equal"] else
               f"within {rec['rel_err']:.2e} ({rec['mismatched']} leaf-ranks not bit-equal)")
        log(f"  {label:22s} == the simulated Communicator {how}; {rec['bytes'] / 1e9:.3f} GB a "
            f"rank == the model; {s:.2f} s (staging {stage:.2f} s, {stage / s:.0%}; wire "
            f"{rec['wire_s']:.2f} s)")
    step = ranks[0]["step"]
    res["step"] = dict(step, s_max=max(rk["step"]["s"] for rk in ranks))
    log(f"  one butterfly step a process: parameters and moments == the simulated-rank step "
        f"bit for bit on every rank; loss {step['loss']:.4f} (simulated "
        f"{step['sim_loss']:.4f}); {step['bytes'] / 1e9:.3f} GB a rank; "
        f"{res['step']['s_max']:.2f} s")
    return res


def run_multi(dev, seed, ck, gloo=True):
    """Phase 3c: the LM side's multi-device half (module docstring, item
    3c). The graph kernels are not on this path: their counts stay 0, in
    this process and in the gloo processes. ``gloo=False`` leaves (d) to
    the caller (:func:`gloo_phases`)."""
    import torch

    from repro_torch.kernels import build

    build.reset_launches()
    out = {"placement": placement(dev, seed)}
    gc.collect()
    torch.cuda.empty_cache()
    out["restore"] = elastic_restore(dev, ck)
    gc.collect()
    torch.cuda.empty_cache()
    out["gpipe"] = gpipe(dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    if gloo:
        out["dist"] = dist_sync(dev, seed)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the multi-device path launched graph kernels: {launched}")
    log("  the multi-device path launched none of the four graph kernels")
    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The LM side's tensor parallelism (phase 3e)
# ---------------------------------------------------------------------------

# qwen3-1.7b sharded over (data 2, model 4) on simulated ranks: (a) serving
# LM_BATCH prompts of TP_PROMPT tokens and TP_NEW greedy tokens in bfloat16,
# and in float32 (TF32 off) prefill + teacher-forced decode at TP_CHECK
# (batch, prompt, steps) against the unsharded forward at the reference's
# tolerance; (b) one float32 step of the 2-layer cut (RESTART_LAYERS) of
# TRAIN_BATCH x TRAIN_SEQ in the config's microbatches against the
# unsharded step, each leaf within TP_REL_TOL of its largest; (c)
# TP_TRAIN_STEPS bfloat16 steps at full width through train.loop.train; (d) the
# butterfly step with the model axis inside in TP_GLOO_WORLD gloo processes
# on (data 2, model 2), TP_GLOO_BATCH x TP_GLOO_SEQ tokens of the 2-layer
# cut, against the same step on simulated ranks
TP_MESH = ((2, 4), ("data", "model"))
TP_PROMPT, TP_NEW = 512, 32
TP_CHECK = (2, 1024, 16)
TP_REL_TOL = 1e-5
TP_PEAK_LIMIT = 75e9
TP_GLOO_WORLD, TP_GLOO_MESH = 4, ((2, 2), ("data", "model"))
TP_GLOO_BATCH, TP_GLOO_SEQ = 4, 256
# (c)'s steps at full width: 3b times the unsharded step already
TP_TRAIN_STEPS = 4


def tp_bytes_check(label, model, calls, ordered=True):
    """The model's ``TensorParallel`` record against the byte model's
    ``calls`` (every call, in order; unordered for a step, whose backward
    runs the layers in reverse) and each rank's bytes against their wire
    bytes; returns the bytes a rank."""
    size = model.tp.size
    have, want_calls = list(model.tp.calls), list(calls)
    if not ordered:
        have, want_calls = sorted(have), sorted(want_calls)
    if have != want_calls:
        raise AssertionError(f"{label}: {len(model.tp.calls)} model-axis calls recorded, "
                             f"the byte model has {len(calls)}")
    want = sum((size - 1) * b for _, b in calls)
    if set(int(b) for b in model.tp.bytes_sent) != {want}:
        raise AssertionError(f"{label}: bytes a rank {model.tp.bytes_sent}, model {want}")
    return want


def tp_serve(dev, seed):
    """(a) qwen3-1.7b at its published size, seeded, sharded over (data 2,
    model 4): ``generate(rules=, mesh=)`` of LM_BATCH prompts, TP_NEW
    greedy tokens, timed step by step, its model-axis calls and each
    rank's bytes equal to the byte model; the share of its tokens equal to
    the unsharded run's; peak memory. Then in float32 with TF32 off, the
    sharded prefill and teacher-forced decode against the unsharded
    forward's logits at LM_RTOL / LM_ATOL."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm
    from repro_torch.serve import engine

    cfg = configs.get_config(LM_ARCH)
    mesh = SimMesh(*TP_MESH)
    rules = rules_for_mesh(mesh)
    size, groups = mesh.shape["model"], mesh.shape["data"]
    torch.cuda.reset_peak_memory_stats()
    plain = api.init_params(cfg, seed, device=dev)
    sharded = api.shard(plain, rules, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, TP_PROMPT), generator=gen, device=dev)
    timed_generate(cfg, plain, prompts, 2)  # warm-up: cuBLAS, the allocator
    want, p_ms, d_ms = timed_generate(cfg, plain, prompts, TP_NEW)
    timed_generate(cfg, sharded, prompts, 2, rules, mesh)
    sharded.tp.reset()
    got, tp_p_ms, tp_d_ms = timed_generate(cfg, sharded, prompts, TP_NEW, rules, mesh)
    rows = LM_BATCH // groups
    calls = (lm.tp_calls(cfg, "prefill", rows, TP_PROMPT, size)
             + lm.tp_calls(cfg, "decode", rows, TP_PROMPT, size) * (TP_NEW - 1))
    per_rank = tp_bytes_check("sharded serving", sharded, calls)
    prefill_bytes = sum((size - 1) * b for _, b in lm.tp_calls(cfg, "prefill", rows,
                                                                   TP_PROMPT, size))
    peak = torch.cuda.max_memory_allocated()
    if not ((got >= 0) & (got < cfg.vocab)).all():
        raise AssertionError("sharded generate: token ids outside the vocabulary")
    share = float((got == want).mean())
    first = float((got[:, 0] == want[:, 0]).mean())
    res = dict(batch=LM_BATCH, prompt=TP_PROMPT, new=TP_NEW, mesh=TP_MESH,
               prefill_ms=tp_p_ms, decode_ms_median=float(np.median(tp_d_ms)),
               plain_prefill_ms=p_ms, plain_decode_ms_median=float(np.median(d_ms)),
               bytes_per_rank=per_rank, prefill_bytes_per_rank=prefill_bytes,
               decode_bytes_per_rank=(per_rank - prefill_bytes) / (TP_NEW - 1),
               n_calls=len(calls), tokens_equal_share=share, first_tokens_equal=first,
               peak_bytes=peak)
    log(f"  {cfg.name} bf16 sharded over data {groups} x model {size}: prefill "
        f"{tp_p_ms:.2f} ms (unsharded {p_ms:.2f}), decode {res['decode_ms_median']:.2f} ms "
        f"a step median (unsharded {res['plain_decode_ms_median']:.2f}); {len(calls)} "
        f"model-axis calls == the byte model, {per_rank / 1e6:.3f} MB a rank (prefill "
        f"{prefill_bytes / 1e6:.3f} MB, a decode step {res['decode_bytes_per_rank'] / 1e6:.4f} "
        f"MB); greedy tokens equal to the unsharded run's: {share:.1%} (first token "
        f"{first:.0%}); peak {peak / 1e9:.2f} GB")
    del plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    b, p, s = TP_CHECK
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    with exact_float32(), torch.inference_mode():
        plain = api.init_params(cfg32, seed, device=dev)
        toks = torch.randint(0, cfg.vocab, (b, p + s), generator=gen, device=dev)
        full = lm.lm_logits(cfg32, plain, lm.forward_hidden(cfg32, plain, toks))
        sharded = api.shard(plain, rules, mesh)
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        logits, cache, pos = api.prefill_fn(cfg32, rules, mesh)(sharded, {"tokens": toks[:, :p]})
        cache = engine.prepare_decode_cache(cfg32, cache, p, p + s)
        outs = [logits]
        decode = api.decode_fn(cfg32, rules, mesh)
        for i in range(s - 1):
            logits, cache = decode(sharded, cache, toks[:, p + i:p + i + 1], p + i)
            outs.append(logits)
        got32 = torch.stack(outs, dim=1)
        res["float32"] = check_close("sharded prefill + decode vs the unsharded forward",
                                     got32, full[:, p - 1:p + s - 1], LM_RTOL, LM_ATOL)
    log(f"  float32 (TF32 off), {b} x {p} prefill + {s - 1} teacher-forced decode steps "
        f"sharded == the unsharded forward: max |err| {res['float32']['max_abs_err']:.3g}, "
        f"{res['float32']['tol_share']:.1%} of rtol {LM_RTOL} atol {LM_ATOL}")
    del sharded, full, cache, got32, outs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def leaf_rel_errs(got, want):
    """Each leaf's largest absolute difference over its largest magnitude."""
    from repro_torch.dist.sharding import sorted_leaves

    g = dict(sorted_leaves(got))
    out = {}
    for path, w in sorted_leaves(want):
        w = w.float()
        scale = float(w.abs().max()) or 1.0
        out["/".join(path)] = float((g[path].float().to(w.device) - w).abs().max()) / scale
    return out


def worst_leaf(errs):
    """The leaf of the largest error, a NaN first (NaN compares false)."""
    return max(errs, key=lambda k: float("inf") if math.isnan(errs[k]) else errs[k])


def tp_step_check(dev, seed):
    """(b) one float32 step (TF32 off) of the 2-layer cut at full width,
    sharded over (data 2, model 4): the loss and every leaf's gradient
    within TP_REL_TOL of its largest against the unsharded gradient of the
    same microbatches; the step's model-axis calls (remat's recompute
    included) equal to the byte model, then the whole GSPMD step's (clip
    and AdamW added)."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm
    from repro_torch.train import optim, step as step_mod

    base = configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=RESTART_LAYERS, param_dtype="float32",
                     compute_dtype="float32")
    mesh = SimMesh(*TP_MESH)
    rules = rules_for_mesh(mesh)
    size, groups = mesh.shape["model"], mesh.shape["data"]
    mb = base.train_microbatches
    batch = device_batch(SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ), 1, dev)
    torch.cuda.reset_peak_memory_stats()
    with exact_float32():
        plain = api.init_params(cfg, seed, device=dev)
        loss0, g0 = step_mod._grads_of(api.train_loss_fn(cfg), plain, batch, mb)
        sharded = api.shard(plain, rules, mesh)
        del plain
        sharded.tp.reset()
        loss1, g1 = step_mod._grads_of(api.train_loss_fn(cfg, rules, mesh), sharded, batch, mb)
        g1 = api.global_leaves(sharded, g1)
        calls = lm.tp_calls(cfg, "train", TRAIN_BATCH // mb // groups, TRAIN_SEQ, size) * mb
        grad_bytes = tp_bytes_check("sharded gradient", sharded, calls, ordered=False)
        errs = leaf_rel_errs(g1, g0)
        loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        del g0, g1
        gc.collect()
        torch.cuda.empty_cache()
        worst = worst_leaf(errs)
        if not (loss_err <= TP_REL_TOL and errs[worst] <= TP_REL_TOL):
            raise AssertionError(f"sharded step: loss rel err {loss_err:.3g}, gradient "
                                 f"{worst} {errs[worst]:.3g} > {TP_REL_TOL}")
        state = optim.get(cfg.optimizer).init(sharded)
        sharded.tp.reset()
        fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, microbatches=mb,
                                       lr_kw=TRAIN_LR)
        _, _, m = fn(sharded, state, batch, 1)
        step_bytes = tp_bytes_check("sharded step", sharded, calls + optim.tp_calls(sharded),
                                    ordered=False)
    res = dict(layers=RESTART_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=mb,
               loss=float(loss0), loss_rel_err=loss_err, worst_leaf=worst,
               worst_rel_err=errs[worst], grad_bytes_per_rank=grad_bytes,
               step_bytes_per_rank=step_bytes, n_calls=len(calls),
               step_loss=float(m["loss"]), peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  float32 (TF32 off) {RESTART_LAYERS}-layer cut, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"in {mb} microbatches, sharded over data {groups} x model {size}: loss "
        f"{float(loss1):.6f} (unsharded {float(loss0):.6f}, rel err {loss_err:.2e}), every "
        f"leaf's gradient within {errs[worst]:.2e} of its largest (worst {worst}); "
        f"{len(calls)} model-axis calls == the byte model (remat's recompute included), "
        f"{grad_bytes / 1e9:.3f} GB a rank, the whole step {step_bytes / 1e9:.3f} GB")
    del sharded, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_train(dev, seed, mesh_sizes=TP_MESH):
    """(c) qwen3-1.7b at its published size, sharded over ``mesh_sizes``,
    trained TP_TRAIN_STEPS steps by ``train.loop.train`` (bfloat16, remat,
    AdamW, the GSPMD step, the config's microbatches): every loss finite,
    the last below the first; step ms, tokens a second, 6ND against the
    bfloat16 peak, peak memory (over TP_PEAK_LIMIT the caller cuts the
    data axis)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh
    from repro_torch.models import api
    from repro_torch.train import loop

    cfg = configs.get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    t0 = time.perf_counter()
    out = loop.train(cfg, TRAIN_BATCH, TRAIN_SEQ,
                     loop.LoopConfig(n_steps=TP_TRAIN_STEPS,
                                     microbatches=cfg.train_microbatches,
                                     lr_kw=TRAIN_LR, log_every=TP_TRAIN_STEPS),
                     seed=seed, on_metrics=lambda s, m: rows.append(m), device=dev,
                     mesh=SimMesh(*mesh_sizes))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"sharded training: losses {losses}")
    step_s = [r["step_time"] for r in rows]
    med = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = api.model_flops(cfg, configs.ShapeConfig("smoke", TRAIN_SEQ, TRAIN_BATCH, "train"))
    res = dict(mesh=mesh_sizes, steps=TP_TRAIN_STEPS, losses=losses, step_s=step_s,
               step_s_median=med, tokens_per_s=tokens / med, model_flops=flops,
               peak_share=flops / med / H100_BF16_FLOPS, peak_bytes=peak, wall_s=wall_s)
    log(f"  {cfg.name} sharded over {dict(zip(mesh_sizes[1], mesh_sizes[0]))}: "
        f"{TP_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step {med * 1e3:.1f} ms median of steps 2-{TP_TRAIN_STEPS} "
        f"(first {step_s[0] * 1e3:.1f} ms), {tokens / med:,.0f} tokens/s, 6ND "
        f"{res['peak_share']:.1%} of the bf16 peak; peak {peak / 1e9:.2f} GB; "
        f"{wall_s:.1f} s in all")
    return res


def tp_child(rank, world, out_dir, job):
    """One process of phase 3e(d) (gloo, every process on the card) or of
    ``--multi-card`` (nccl, card ``rank``): the ``job["cfg"]`` model seeded
    and sharded over ``job["mesh"]`` through a ``DistCommunicator``. With
    ``"serve"`` in ``job["parts"]``: the float32 prefill logits of its data
    group's rows and, in the config's dtype, ``generate``'s greedy tokens;
    with ``"step"``: one train step (``job["step_kind"]``) in float32, TF32
    off (``job["fsdp"]``: with FSDP rules). Rank 0 runs the same on
    simulated ranks on its card and holds each process's results to it:
    logits and every gradient leaf within TP_REL_TOL of its largest, the
    loss too, the records equal, the parameters after the update within
    the update's bound (not gathered for an FSDP job); each process's peak
    over its step. Writes ``rank<r>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.process import DistCommunicator
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serve import engine
    from repro_torch.train import optim, step as step_mod
    from repro_torch.core import collectives

    t_start = time.perf_counter()
    nccl = job["backend"] == "nccl"
    dev = torch.device("cuda", rank) if nccl else torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    else:  # the processes share the host's cores
        torch.set_num_threads(1)

    def synchronize():
        if cuda:
            torch.cuda.synchronize(dev)

    torch.set_float32_matmul_precision("highest")
    build.reset_launches()
    mesh = SimMesh(*job["mesh"])
    rules = rules_for_mesh(mesh, job.get("fsdp", False))
    groups = mesh.shape["data"]
    group = int(mesh.coords([rank])[0][0])
    comm = DistCommunicator(dev, mesh)
    res = {"rank": rank}

    def programs():
        """(this process's, rank 0's simulated) or (this process's,)."""
        yield comm, "dist"
        if rank == 0:
            yield collectives.Communicator(mesh, dev), "sim"

    got = {}
    if "serve" in job["parts"]:
        cfg = job["serve_cfg"]
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(job["seed"])
        toks, extra = tpf_inputs(cfg, job["serve_batch"], job["serve_prompt"], gen, "cpu")
        for c, name in programs():
            ins = dict(extra, tokens=toks)
            if name != "sim":
                ins = step_mod._split_batch(ins, groups)[group]
            ins = {k: v.to(dev) for k, v in ins.items()}
            mine = ins.pop("tokens")
            m32 = api.init_params(cfg32, job["seed"], device=dev, rules=rules, mesh=mesh, comm=c)
            with torch.inference_mode():
                logits, _, _ = api.prefill_fn(cfg32, rules, mesh)(m32, dict(ins, tokens=mine))
            got[(name, "logits")] = logits.float().cpu()
            del m32
            m = api.init_params(cfg, job["seed"], device=dev, rules=rules, mesh=mesh, comm=c)
            t0 = time.perf_counter()
            out = engine.generate(cfg, m, mine, job["serve_new"], extra_inputs=ins or None,
                                  rules=rules, mesh=mesh)
            synchronize()
            got[(name, "tokens")] = out.tokens
            got[(name, "serve_s")] = time.perf_counter() - t0
            got[(name, "serve_stats")] = _records(m)
            del m
            if cuda:
                torch.cuda.empty_cache()
    if "step" in job["parts"]:
        cfg = job["step_cfg"]
        batch = device_batch(SyntheticLM(cfg, job["batch"], job["seq"]), 1, dev)
        real = optim.get(cfg.optimizer)
        for c, name in programs():
            m = api.init_params(cfg, job["seed"], device=dev, rules=rules, mesh=mesh, comm=c)
            state = real.init(m)
            caught = {}

            def apply(model, grads, st, lr, caught=caught):
                """The optimizer's update; the (clipped) gradient it takes
                kept as held, gathered whole after the step."""
                caught["grads"], caught["lr"] = grads, lr
                return real.apply(model, grads, st, lr)

            hooked = dataclasses.replace(real, apply=apply)
            get, optim.get = optim.get, lambda _name: hooked
            try:
                if job["step_kind"] == "butterfly":
                    fn = step_mod.build_train_step_butterfly(
                        cfg, mesh, rules, lr_kw=TRAIN_LR, comm=c if name == "dist" else None)
                else:
                    fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, lr_kw=TRAIN_LR)
            finally:
                optim.get = get
            _reset_records(m)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m, state, met = fn(m, state, batch, 1)
            synchronize()
            got[(name, "step_s")] = time.perf_counter() - t0
            got[(name, "step_peak_bytes")] = torch.cuda.max_memory_allocated(dev) if cuda else 0
            got[(name, "loss")] = float(met["loss"])
            got[(name, "step_stats")] = _records(m)
            # collective under dist: every process gathers (an FSDP job's
            # check is the gradient's: its parameters are not gathered)
            grads = api.global_leaves(m, caught.pop("grads"))
            params = None if job.get("fsdp") else api.to_reference(m)
            if rank == 0:
                got[(name, "grads")], got[(name, "lr")] = grads, caught["lr"]
                if params is not None:
                    got[(name, "params")] = params
            del m, state, params, grads, caught
            if cuda:
                torch.cuda.empty_cache()
    # rank 0 holds every process to its simulated run; the parameters and
    # the gradient stay home (all_gather_object pads every rank's object to
    # the largest and hands each process all of them: rank 0's gradient
    # would be world x world copies on the host)
    mine = {k[1]: v for k, v in got.items()
            if k[0] == "dist" and k[1] not in ("params", "grads")}
    everyone = [None] * world
    dist.all_gather_object(everyone, {k: v for k, v in mine.items()})
    if rank == 0:
        checks = {}
        for r, theirs in enumerate(everyone):
            g = int(mesh.coords([r])[0][0])
            if "logits" in theirs:
                want = step_mod._split_batch({"x": got[("sim", "logits")]}, groups)[g]["x"]
                err = float((theirs["logits"] - want).abs().max()) / float(want.abs().max())
                toks_w = step_mod._split_batch({"x": torch.from_numpy(got[("sim", "tokens")])},
                                               groups)[g]["x"].numpy()
                checks[f"rank{r}_logits_rel_err"] = err
                checks[f"rank{r}_tokens_equal"] = float((theirs["tokens"] == toks_w).mean())
                if err > TP_REL_TOL or theirs["serve_stats"] != got[("sim", "serve_stats")]:
                    raise AssertionError(f"rank {r}: prefill logits rel err {err:.3g} or its "
                                         f"record differs from the simulated ranks'")
            if "loss" in theirs:
                lerr = abs(theirs["loss"] - got[("sim", "loss")]) / abs(got[("sim", "loss")])
                checks[f"rank{r}_loss_rel_err"] = lerr
                if lerr > TP_REL_TOL or theirs["step_stats"] != got[("sim", "step_stats")]:
                    raise AssertionError(f"rank {r}: loss rel err {lerr:.3g} or its record "
                                         f"differs from the simulated ranks'")
        if ("dist", "grads") in got:
            errs = leaf_rel_errs(got[("dist", "grads")], got[("sim", "grads")])
            worst = max(errs, key=errs.get)
            checks.update(grads_worst=worst, grads_rel_err=errs[worst])
            over = {k: e for k, e in errs.items() if e > TPF_LEAF_TOL.get(k, TP_REL_TOL)}
            if over:
                raise AssertionError(f"dist step: gradient leaves over their bound: {over}")
        if ("dist", "params") in got:
            # the parameters after the update, reported: AdamW's first
            # update g / (|g| + eps) is ill-conditioned wherever the clipped
            # |g| nears eps (most elements here), so a gradient's last bits
            # move a parameter by up to 2 lr
            pairs = list(zip(_flat_items(got[("dist", "params")]),
                             _flat_items(got[("sim", "params")])))
            moved = max(float(np.abs(a - b).max()) for (_, a), (_, b) in pairs)
            rel = max(float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)
                      for (_, a), (_, b) in pairs)
            checks.update(params_worst_rel_err=rel, params_max_abs_err=moved,
                          update_bound=2 * got[("sim", "lr")])
            if moved > 2 * got[("sim", "lr")]:
                raise AssertionError(f"dist step: a parameter moved {moved:.3g} from the "
                                     f"simulated step's, over the update's bound")
        res["checks"] = checks
        res["sim"] = {k[1]: v for k, v in got.items() if k[0] == "sim"
                      and k[1] in ("step_s", "serve_s", "loss")}
    res["dist"] = {k: v for k, v in mine.items()
                   if k in ("step_s", "serve_s", "loss", "step_peak_bytes")}
    res["stage_s"], res["wire_s"] = comm.stage_s, comm.wire_s
    res["launches"] = {k: v for k, v in build.LAUNCHES.items() if v}
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=float)


def _records(model):
    """A sharded model's records: the model axis's and FSDP's, by kind."""
    return {name: None if par is None else {k: dict(v) for k, v in par.stats.items()}
            for name, par in (("tp", model.tp), ("fsdp", getattr(model, "fsdp", None)))}


def _reset_records(model):
    for par in (model.tp, getattr(model, "fsdp", None)):
        if par is not None:
            par.reset()


def _flat_items(tree, path=()):
    """(path, leaf) of a nested dict, sorted keys (the reference's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_items(tree[k], path + (k,))
    else:
        yield path, tree


def tp_group(dev, seed, job, world, backend):
    """``tp_child`` in ``world`` processes of a ``backend`` group, joined with a
    deadline; each process's record, rank 0's checks."""
    job = dict(job, seed=seed, device=str(dev), backend=backend)
    out_dir = tempfile.mkdtemp(prefix="repro_torch_tp_")
    try:
        t0 = time.perf_counter()
        codes = run_children(tp_child, world, (out_dir, job), backend)
        wall_s = time.perf_counter() - t0
        if any(codes):
            raise AssertionError(f"tp: the processes exited with {codes}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launched = [rk["launches"] for rk in ranks if rk["launches"]]
    if launched:
        raise AssertionError(f"tp: the processes launched graph kernels: {launched}")
    res = dict(world=world, backend=backend, mesh=job["mesh"], wall_s=wall_s,
               checks=ranks[0]["checks"], sim=ranks[0]["sim"],
               dist=[rk["dist"] for rk in ranks],
               stage_s=[rk["stage_s"] for rk in ranks],
               peak_bytes=[rk["peak_bytes"] for rk in ranks])
    log(f"  {world} {backend} processes on {dict(zip(job['mesh'][1], job['mesh'][0]))} "
        f"({wall_s:.1f} s in all): == the simulated ranks within {TP_REL_TOL} of each "
        f"leaf's largest, records equal: {json.dumps(res['checks'], default=float)}")
    log(f"  per process {json.dumps(res['dist'], default=float)}; simulated "
        f"{json.dumps(res['sim'], default=float)}; host staging "
        f"{[round(s, 2) for s in res['stage_s']]} s; peaks "
        f"{[round(p / 1e9, 2) for p in res['peak_bytes']]} GB")
    return res


def tp_gloo(dev, seed):
    """(d) the butterfly step with the model axis inside, in TP_GLOO_WORLD
    gloo processes on the card on (data 2, model 2), the 2-layer cut in
    float32, against the simulated ranks."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(LM_ARCH), n_layers=RESTART_LAYERS,
                     param_dtype="float32", compute_dtype="float32")
    job = dict(parts=("step",), step_cfg=cfg, step_kind="butterfly", mesh=TP_GLOO_MESH,
               batch=TP_GLOO_BATCH, seq=TP_GLOO_SEQ)
    return tp_group(dev, seed, job, TP_GLOO_WORLD, "gloo")


def run_tp(dev, seed, gloo=True):
    """Phase 3e: the LM side's tensor parallelism (module docstring, item
    3e). The graph kernels are not on this path: their counts stay 0.
    ``gloo=False`` leaves (d) to the caller (:func:`gloo_phases`)."""
    import torch

    from repro_torch.kernels import build

    build.reset_launches()
    out = {"serve": tp_serve(dev, seed)}
    out["step"] = tp_step_check(dev, seed)
    out["train"] = tp_train(dev, seed)
    if out["train"]["peak_bytes"] > TP_PEAK_LIMIT:
        log(f"  peak over {TP_PEAK_LIMIT / 1e9:.0f} GB: again on data 1 x model 4")
        out["train_data1"] = tp_train(dev, seed, ((1, 4), ("data", "model")))
    if gloo:
        out["gloo"] = tp_gloo(dev, seed)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the tensor-parallel path launched graph kernels: {launched}")
    log("  the tensor-parallel path launched none of the four graph kernels")
    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism for the SSM, hybrid, VLM and encoder-decoder families
# (phase 3f)
# ---------------------------------------------------------------------------

# arch: (layers, or None for the published depth; serving batch, prompt
# tokens, new tokens); jamba runs its least depth, one 8-layer period
TPF_SERVE = {"mamba2-130m": (None, 8, 1024, 32), "whisper-medium": (None, 8, 256, 32),
             "internvl2-26b": (2, 8, 256, 32), "jamba-v0.1-52b": (8, 4, 512, 16)}
# float32 (TF32 off): the prefill + teacher-forced decode check (batch,
# prompt, steps) and the step (batch, text tokens, microbatches)
TPF_CHECK = {"mamba2-130m": (2, 1024, 16), "whisper-medium": (2, 256, 16),
             "internvl2-26b": (2, 256, 16)}
TPF_STEP = {"mamba2-130m": (4, 1024, 2), "whisper-medium": (4, 256, 2),
            "internvl2-26b": (4, 256, 2)}
# mamba2-130m's 24 SSM heads on the production mesh's model 16: 1.5 a rank
TPF_STRADDLE = ((1, 16), ("data", "model"))
# bfloat16 serving against the unsharded run: the prefill logits within 8
# bf16 ulps of a logit in [2, 4) (an H100 read 0.0156-0.0547 for the four
# families; their largest logits are 3-16)
TPF_LOGIT_TOL = 0.125
# the float32 step: each leaf's gradient within TP_REL_TOL of its largest,
# these leaves within their own bound: an H100 read mamba2's sharded error
# at 1.18e-5, 1.25e-5 and 1.06e-5 of the largest, and the unsharded
# gradient itself moving 1.05e-5, 1.03e-5 and 9.81e-6 between one
# microbatch and two (a 1024-token scan's float32 sums in another order)
TPF_LEAF_TOL = {"groups/blocks/ssm/A_log": 2.5e-5, "groups/blocks/ssm/dt_bias": 2.5e-5,
                "groups/blocks/ssm/wo": 2.5e-5}


def tpf_config(arch, dtype=None):
    import dataclasses as dc

    from repro_torch import configs

    cfg = configs.get_config(arch)
    layers = TPF_SERVE[arch][0]
    if layers:
        cfg = dc.replace(cfg, n_layers=layers)
    if dtype:
        cfg = dc.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


def tpf_inputs(cfg, batch, n_tokens, gen, dev):
    """Seeded prompts and the family's other inputs (patches, frames)."""
    import torch

    toks = torch.randint(0, cfg.vocab, (batch, n_tokens), generator=gen, device=dev)
    extra = {}
    dt = torch.float32
    if cfg.family == "vlm":
        extra["patches"] = torch.randn((batch, cfg.n_patches, cfg.patch_dim), generator=gen,
                                       device=dev, dtype=dt)
    if cfg.family == "audio":
        extra["frames"] = torch.randn((batch, cfg.n_frames, cfg.d_model), generator=gen,
                                      device=dev, dtype=dt)
    return toks, extra


def full_logits(cfg, model, toks, extra):
    """The unsharded forward's logits at every position (the VLM's prefix
    included), (B, L, V)."""
    from repro_torch.models import encdec, lm

    if cfg.family == "audio":
        h, _ = encdec._decoder(cfg, model, toks, encdec.encode(cfg, model, extra["frames"]))
    else:
        h = lm.forward_hidden(cfg, model, toks, patches=extra.get("patches"))
    return lm.lm_logits(cfg, model, h)


def tpf_serve(arch, dev, seed):
    """bfloat16 serving on TP_MESH: ``generate(rules=, mesh=)`` timed step
    by step against the unsharded run of the same seeded weights (jamba:
    the two never on the card together; the unsharded tokens and prefill
    logits kept on the host), the record and each rank's bytes equal to
    the byte model, every row's first greedy token equal and the prefill
    logits within TPF_LOGIT_TOL of the unsharded run's; the share of all
    tokens equal, peak memory."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm

    cfg = tpf_config(arch)
    _, b, p, new = TPF_SERVE[arch]
    mesh = SimMesh(*TP_MESH)
    rules = rules_for_mesh(mesh)
    size, groups = mesh.shape["model"], mesh.shape["data"]
    apart = cfg.family == "hybrid"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks, extra = tpf_inputs(cfg, b, p, gen, dev)
    ins = dict(extra, tokens=toks)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = api.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(q.numel() for q in plain.parameters())
    if n_params != api.param_counts(cfg)["total"]:
        raise AssertionError(f"{arch}: {n_params} parameters, the config has "
                             f"{api.param_counts(cfg)['total']}")
    timed_generate(cfg, plain, toks, 2, extra=extra)  # warm-up
    want, p_ms, d_ms = timed_generate(cfg, plain, toks, new, extra=extra)
    with torch.inference_mode():
        want_logits = api.prefill_fn(cfg)(plain, ins)[0].float().cpu()
    if apart:
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        sharded = api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh)
    else:
        sharded = api.shard(plain, rules, mesh)
        del plain
        gc.collect()
    timed_generate(cfg, sharded, toks, 2, rules, mesh, extra=extra)
    sharded.tp.reset()
    got, tp_p_ms, tp_d_ms = timed_generate(cfg, sharded, toks, new, rules, mesh, extra=extra)
    rows = b // groups
    calls = (lm.tp_calls(cfg, "prefill", rows, p, size)
             + lm.tp_calls(cfg, "decode", rows, p, size) * (new - 1))
    per_rank = tp_bytes_check(f"{arch} sharded serving", sharded, calls)
    with torch.inference_mode():
        got_logits = api.prefill_fn(cfg, rules, mesh)(sharded, ins)[0].float().cpu()
    peak = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(got_logits).all() and ((got >= 0) & (got < cfg.vocab)).all()):
        raise AssertionError(f"{arch} sharded serving: non-finite logits or ids outside "
                             f"the vocabulary")
    share = float((got == want).mean())
    first = float((got[:, 0] == want[:, 0]).mean())
    diff = float((got_logits - want_logits).abs().max())
    if not (diff <= TPF_LOGIT_TOL and first == 1.0):
        top = want_logits[:, :cfg.vocab].topk(2, dim=-1).values
        raise AssertionError(f"{arch} sharded serving: prefill logits within {diff:.3g} "
                             f"(bound {TPF_LOGIT_TOL}); first tokens {got[:, 0]} against "
                             f"{want[:, 0]} (the unsharded run's top-2 gaps "
                             f"{(top[:, 0] - top[:, 1]).tolist()})")
    res = dict(layers=cfg.n_layers, params=n_params, init_s=init_s, batch=b, prompt=p,
               new=new, mesh=TP_MESH, prefill_ms=tp_p_ms,
               decode_ms_median=float(np.median(tp_d_ms)), plain_prefill_ms=p_ms,
               plain_decode_ms_median=float(np.median(d_ms)), bytes_per_rank=per_rank,
               n_calls=len(calls), tokens_equal_share=share, first_tokens_equal=first,
               prefill_logits_max_abs_diff=diff, apart=apart, peak_bytes=peak)
    log(f"  {arch} ({cfg.n_layers} layers, {n_params:,} parameters, seeded in {init_s:.1f} s) "
        f"bf16 on data {groups} x model {size}, {b} x {p} + {new}: prefill {tp_p_ms:.2f} ms "
        f"(unsharded {p_ms:.2f}), decode {res['decode_ms_median']:.2f} ms a step median "
        f"(unsharded {res['plain_decode_ms_median']:.2f}); {len(calls)} model-axis calls == "
        f"the byte model, {per_rank / 1e6:.3f} MB a rank; greedy tokens equal: {share:.1%} "
        f"(first {first:.0%}); prefill logits within {diff:.3g} of {TPF_LOGIT_TOL}"
        f"{' (the unsharded run on the host)' if apart else ''}; peak {peak / 1e9:.2f} GB")
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tpf_float32(arch, dev, seed, serve=True, train=True):
    """float32 with TF32 off on TP_MESH: (serve) the sharded prefill and
    teacher-forced decode against the unsharded forward at the reference's
    tolerance, and for mamba2 the prefill on TPF_STRADDLE, whose heads
    straddle the ranks; (train) one step's loss within TP_REL_TOL and every
    leaf's gradient within TP_REL_TOL (TPF_LEAF_TOL's leaves their own) of
    its largest against the unsharded gradient, the calls equal to the byte
    model, then the whole GSPMD step's."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm
    from repro_torch.serve import engine
    from repro_torch.train import optim, step as step_mod

    cfg = tpf_config(arch, "float32")
    mesh = SimMesh(*TP_MESH)
    rules = rules_for_mesh(mesh)
    size, groups = mesh.shape["model"], mesh.shape["data"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    res = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with exact_float32():
        plain = api.init_params(cfg, seed, device=dev)
        if serve:
            b, p, s = TPF_CHECK[arch]
            with torch.inference_mode():
                toks, extra = tpf_inputs(cfg, b, p + s, gen, dev)
                off = cfg.n_patches if cfg.family == "vlm" else 0
                want = full_logits(cfg, plain, toks, extra)[:, off + p - 1:off + p + s - 1]
                sharded = api.shard(plain, rules, mesh)
                logits, cache, pos = api.prefill_fn(cfg, rules, mesh)(
                    sharded, dict(extra, tokens=toks[:, :p]))
                cache = engine.prepare_decode_cache(cfg, cache, pos, pos + s)
                outs = [logits]
                decode = api.decode_fn(cfg, rules, mesh)
                for i in range(s - 1):
                    logits, cache = decode(sharded, cache, toks[:, p + i:p + i + 1], pos + i)
                    outs.append(logits)
                res["serve"] = check_close(f"{arch} sharded prefill + decode vs the forward",
                                           torch.stack(outs, dim=1), want, LM_RTOL, LM_ATOL)
                del sharded, cache, outs
                log(f"  {arch} float32, {b} x {p} prefill + {s - 1} teacher-forced decode "
                    f"steps sharded == the unsharded forward: max |err| "
                    f"{res['serve']['max_abs_err']:.3g}, {res['serve']['tol_share']:.1%} of "
                    f"rtol {LM_RTOL} atol {LM_ATOL}")
                if cfg.family == "ssm":
                    wide = SimMesh(*TPF_STRADDLE)
                    wrules = rules_for_mesh(wide)
                    w = wide.shape["model"]
                    sharded = api.shard(plain, wrules, wide)
                    logits, _, _ = api.prefill_fn(cfg, wrules, wide)(
                        sharded, {"tokens": toks[:, :p]})
                    wcalls = lm.tp_calls(cfg, "prefill", b, p, w)
                    tp_bytes_check(f"{arch} prefill on model {w}", sharded, wcalls)
                    res["straddle"] = dict(mesh=TPF_STRADDLE, heads_a_rank=cfg.n_ssm_heads / w,
                                           n_calls=len(wcalls), **check_close(
                                               f"{arch} prefill on model {w} vs the forward",
                                               logits, want[:, 0], LM_RTOL, LM_ATOL))
                    del sharded
                    log(f"  {arch} float32 prefill on data 1 x model {w} ({cfg.n_ssm_heads} "
                        f"heads, {cfg.n_ssm_heads / w} a rank: the scan replicated behind an "
                        f"all-gather) == the forward: max |err| "
                        f"{res['straddle']['max_abs_err']:.3g}; {len(wcalls)} calls == the "
                        f"byte model")
                del want
                gc.collect()
                torch.cuda.empty_cache()
        if train:
            b, text, mb = TPF_STEP[arch]
            seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
            batch = device_batch(SyntheticLM(cfg, b, seq), 1, dev)
            loss0, g0 = step_mod._grads_of(api.train_loss_fn(cfg), plain, batch, mb)
            sharded = api.shard(plain, rules, mesh)
            del plain
            sharded.tp.reset()
            loss1, g1 = step_mod._grads_of(api.train_loss_fn(cfg, rules, mesh), sharded,
                                           batch, mb)
            g1 = api.global_leaves(sharded, g1)
            calls = lm.tp_calls(cfg, "train", b // mb // groups, text, size) * mb
            grad_bytes = tp_bytes_check(f"{arch} sharded gradient", sharded, calls,
                                        ordered=False)
            errs = leaf_rel_errs(g1, g0)
            loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
            del g0, g1
            gc.collect()
            torch.cuda.empty_cache()
            worst = worst_leaf(errs)
            bound = {k: TPF_LEAF_TOL.get(k, TP_REL_TOL) for k in errs}
            over = {k: (errs[k], bound[k]) for k in errs if not errs[k] <= bound[k]}
            own = {k: errs[k] for k in TPF_LEAF_TOL if k in errs}
            if not loss_err <= TP_REL_TOL or over:
                raise AssertionError(f"{arch} sharded step: loss rel err {loss_err:.3g}, "
                                     f"leaves over their bound (error, bound): {over}")
            state = optim.get(cfg.optimizer).init(sharded)
            sharded.tp.reset()
            fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, microbatches=mb,
                                           lr_kw=TRAIN_LR)
            _, _, m = fn(sharded, state, batch, 1)
            step_bytes = tp_bytes_check(f"{arch} sharded step", sharded,
                                        calls + optim.tp_calls(sharded), ordered=False)
            res["step"] = dict(batch=b, tokens=seq, microbatches=mb, loss=float(loss0),
                               loss_rel_err=loss_err, worst_leaf=worst,
                               worst_rel_err=errs[worst], own_bound_leaves=own,
                               n_calls=len(calls),
                               grad_bytes_per_rank=grad_bytes, step_bytes_per_rank=step_bytes,
                               step_loss=float(m["loss"]))
            log(f"  {arch} float32 step, {b} x {seq} tokens in {mb} microbatches: loss "
                f"{float(loss1):.6f} (unsharded {float(loss0):.6f}, rel err {loss_err:.2e}), "
                f"every leaf's gradient within {errs[worst]:.2e} of its largest (worst "
                f"{worst}); the leaves held to their own bound (TPF_LEAF_TOL): "
                f"{json.dumps(own)}; {len(calls)} model-axis calls == the byte model, "
                f"{grad_bytes / 1e9:.3f} GB a rank, the whole step {step_bytes / 1e9:.3f} GB")
            del sharded, state
        else:
            del plain
    res["seconds"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_tp_families(dev, seed, serve=True, train=True):
    """Phase 3f: tensor parallelism for the SSM, VLM, encoder-decoder and
    hybrid families (module docstring, item 3f). The graph kernels are not
    on this path: their counts stay 0."""
    import torch

    from repro_torch.kernels import build

    build.reset_launches()
    out = {}
    for arch in TPF_SERVE:
        t0 = time.perf_counter()
        out[arch] = {}
        if serve:
            out[arch]["serve"] = tpf_serve(arch, dev, seed)
        if arch in TPF_CHECK and (serve or train):
            out[arch]["float32"] = tpf_float32(arch, dev, seed, serve=serve, train=train)
        out[arch]["seconds"] = time.perf_counter() - t0
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"phase 3f launched graph kernels: {launched}")
    spent = ", ".join(f"{a} {o['seconds']:.1f} s" for a, o in out.items())
    log(f"  phase 3f launched none of the four graph kernels; {spent}")
    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) over the data axes beside tensor parallelism (phase 3g)
# ---------------------------------------------------------------------------

# deepseek-7b (fsdp=True) on (data 2, model 4) simulated ranks with
# rules_for_mesh(mesh, fsdp=True), against the tensor-parallel run of the
# same seeded weights: (a) bfloat16 serving at the published size,
# FSDP_SERVE = (prompts, prompt tokens, greedy tokens); (b) FSDP_TRAIN_STEPS
# bfloat16 steps of the FSDP_TRAIN_LAYERS-layer cut at full width through
# train.loop.train (FSDP_TRAIN_BATCH x FSDP_TRAIN_SEQ tokens, the config's
# microbatches) after the same steps tensor-parallel alone, and one float32
# step of the 2-layer cut, FSDP_STEP = (rows, tokens, microbatches), against
# the tensor-parallel step; (c) one FSDP GSPMD step in TP_GLOO_WORLD gloo
# processes on (data 2, model 2), the 2-layer cut, FSDP_GLOO_BATCH x
# FSDP_GLOO_SEQ tokens, against the simulated ranks (beside phase 4, after
# 3e(d))
FSDP_ARCH = "deepseek-7b"
FSDP_SERVE = (8, 256, 16)
FSDP_TRAIN_LAYERS, FSDP_TRAIN_STEPS = 8, 3
FSDP_TRAIN_BATCH, FSDP_TRAIN_SEQ = 8, 1024
FSDP_STEP = (4, 512, 2)
FSDP_GLOO_BATCH, FSDP_GLOO_SEQ = 4, 256
# (b)'s bf16 losses against the tensor-parallel run's, relative
FSDP_LOSS_TOL = 1e-2


def fsdp_bytes_check(label, model, calls, ordered=True):
    """The model's ``FullyShardedData`` record against the byte model's
    ``calls`` (in order, or unordered for a step) and each rank's bytes
    against their wire bytes; returns the bytes a rank."""
    from repro_torch.models import lm

    fs = model.fsdp
    have, want_calls = list(fs.calls), list(calls)
    if not ordered:
        have, want_calls = sorted(have), sorted(want_calls)
    if have != want_calls:
        raise AssertionError(f"{label}: {len(fs.calls)} FSDP calls recorded, the byte model "
                             f"has {len(calls)}")
    stats = lm.tp_stats(calls, fs.size)
    want = int(sum(v["wire_bytes"] for v in stats.values()))
    if fs.stats != stats or set(int(b) for b in fs.bytes_sent) != {want}:
        raise AssertionError(f"{label}: bytes a rank {fs.bytes_sent}, model {want}")
    return want


def fsdp_serve(dev, seed, cfg=None, shape=FSDP_SERVE, apart=False, keep=None):
    """(a) ``cfg`` (deepseek-7b at its published size by default), seeded,
    with FSDP rules on (data 2, model 4) beside the tensor-parallel model of
    the same weights (``apart``: the tensor-parallel run first and its
    tokens and logits kept on the host, the two models never on the card
    together): ``generate(rules=, mesh=)`` of both timed step by step on
    ``shape`` = (prompts, prompt tokens, greedy tokens) and the family's
    other inputs, the prefill logits and every token of the FSDP run equal
    to the tensor-parallel run's bit for bit (a gather is a concatenation;
    where the card's GEMM takes another algorithm for a gathered tensor,
    logged, and then held to 3f's bounds: every first token equal, the
    prefill logits within TPF_LOGIT_TOL), every FSDP and model-axis call
    and each rank's bytes equal to the byte models, peak memory. A dict
    ``keep`` receives the FSDP run's tokens."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm

    cfg = cfg or configs.get_config(FSDP_ARCH)
    b, p, new = shape
    mesh = SimMesh(*TP_MESH)
    rules, tp_rules = rules_for_mesh(mesh, fsdp=True), rules_for_mesh(mesh)
    size, groups = mesh.shape["model"], mesh.shape["data"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompts, extra = tpf_inputs(cfg, b, p, gen, dev)
    ins = dict(extra, tokens=prompts)
    t0 = time.perf_counter()
    base = api.init_params(cfg, seed, device=dev, rules=tp_rules, mesh=mesh)
    if not apart:
        model = api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.param_counts(cfg)["total"]
    timed_generate(cfg, base, prompts, 2, tp_rules, mesh, extra)  # warm-up
    base.tp.reset()
    want, p_ms, d_ms = timed_generate(cfg, base, prompts, new, tp_rules, mesh, extra)
    with torch.inference_mode():
        la = api.prefill_fn(cfg, tp_rules, mesh)(base, ins)[0]
    if apart:
        la = la.cpu()
        del base
        gc.collect()
        torch.cuda.empty_cache()
        model = api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh)
    timed_generate(cfg, model, prompts, 2, rules, mesh, extra)
    model.tp.reset()
    model.fsdp.reset()
    got, f_p_ms, f_d_ms = timed_generate(cfg, model, prompts, new, rules, mesh, extra)
    rows = b // groups
    tp_calls = (lm.tp_calls(cfg, "prefill", rows, p, size)
                + lm.tp_calls(cfg, "decode", rows, p, size) * (new - 1))
    tp_bytes = tp_bytes_check(f"{cfg.name} FSDP serving's model axis", model, tp_calls)
    fs_calls = (lm.fsdp_calls(cfg, "prefill", mesh, rules)
                + lm.fsdp_calls(cfg, "decode", mesh, rules) * (new - 1))
    fs_bytes = fsdp_bytes_check(f"{cfg.name} FSDP serving", model, fs_calls)
    prefill_gathered = sum(nb for _, nb in lm.fsdp_calls(cfg, "prefill", mesh, rules))
    with torch.inference_mode():
        lb = api.prefill_fn(cfg, rules, mesh)(model, ins)[0].to(la.device)
    peak = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(lb).all() and ((got >= 0) & (got < cfg.vocab)).all()):
        raise AssertionError(f"{cfg.name} FSDP serving: non-finite logits or ids outside "
                             f"the vocabulary")
    exact = bool(torch.equal(la, lb)) and bool((got == want).all())
    diff = float((la.float() - lb.float()).abs().max())
    first = float((got[:, 0] == want[:, 0]).mean())
    share = float((got == want).mean())
    if not exact:
        where = torch.nonzero(la != lb)
        log(f"  the FSDP run is not bit-equal to the tensor-parallel run: prefill logits "
            f"differ at {where.shape[0]} of {la.numel()} entries (first {where[:4].tolist()}), "
            f"max |diff| {diff:.3g}; tokens equal {share:.1%}: held to 3f's bounds")
        if not (diff <= TPF_LOGIT_TOL and first == 1.0):
            raise AssertionError(f"{cfg.name} FSDP serving: prefill logits differ by "
                                 f"{diff:.3g} (bound {TPF_LOGIT_TOL}) or first tokens differ")
    if keep is not None:
        keep["tokens"] = got
    res = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params, batch=b, prompt=p,
               new=new, mesh=TP_MESH, init_s=init_s, prefill_ms=f_p_ms,
               decode_ms_median=float(np.median(f_d_ms)), tp_prefill_ms=p_ms,
               tp_decode_ms_median=float(np.median(d_ms)), bit_equal=exact,
               prefill_logits_max_diff=diff, tokens_equal_share=share,
               first_tokens_equal=first, fsdp_calls=len(fs_calls), tp_calls=len(tp_calls),
               fsdp_bytes_per_rank=fs_bytes, tp_bytes_per_rank=tp_bytes,
               prefill_gathered_bytes_per_rank=prefill_gathered, apart=apart,
               peak_bytes=peak)
    log(f"  {cfg.name} ({n_params:,} parameters, {cfg.n_layers} layers) bf16 with FSDP rules "
        f"on data {groups} x model {size} ({'the tensor-parallel run first, apart' if apart else 'seeded with the tensor-parallel copy'} in "
        f"{init_s:.1f} s), {b} x {p} + {new}: prefill {f_p_ms:.2f} ms (tensor-parallel alone "
        f"{p_ms:.2f}), decode {res['decode_ms_median']:.2f} ms a step median (tensor-parallel "
        f"alone {res['tp_decode_ms_median']:.2f}); {'bit-equal' if exact else 'NOT bit-equal'} "
        f"to the tensor-parallel run (prefill logits and all {b} x {new} tokens); "
        f"{len(fs_calls)} FSDP calls == lm.fsdp_calls, {fs_bytes / 1e9:.3f} GB a rank "
        f"(prefill {prefill_gathered / 1e6:.1f} MB of gathered blocks), {len(tp_calls)} "
        f"model-axis calls == lm.tp_calls, {tp_bytes / 1e6:.3f} MB a rank; peak "
        f"{peak / 1e9:.2f} GB")
    del model, la, lb
    if not apart:
        del base
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fsdp_step_check(dev, seed, cfg=None, shape=None, mesh_sizes=TP_MESH):
    """(b) one float32 step (TF32 off) of ``cfg`` (the 2-layer cut of
    deepseek-7b at full width by default) on ``shape`` = (rows, text
    tokens, microbatches) with FSDP rules on ``mesh_sizes`` (data 2, model
    4 by default; with a ``pod`` axis, FSDP over pod and data) against the
    tensor-parallel step of the same weights and batch: the loss and every
    leaf's gradient within TP_REL_TOL of its largest (TPF_LEAF_TOL's leaves
    their own), the records of the gradient (remat's recompute, each
    gathered leaf's reduce-scatter) and then of the whole GSPMD step (the
    clip's and the optimizer's calls) equal to the byte models, the
    parameters after the update within TP_REL_TOL of each leaf's
    largest."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api, lm
    from repro_torch.train import optim, step as step_mod

    if cfg is None:
        cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=RESTART_LAYERS,
                                  param_dtype="float32", compute_dtype="float32")
    rows, text, mb = shape or FSDP_STEP
    seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
    mesh = SimMesh(*mesh_sizes)
    rules, tp_rules = rules_for_mesh(mesh, fsdp=True), rules_for_mesh(mesh)
    size = mesh.shape["model"]
    groups = mesh.ranks // size
    batch = device_batch(SyntheticLM(cfg, rows, seq), 1, dev)
    torch.cuda.reset_peak_memory_stats()
    with exact_float32():
        base = api.init_params(cfg, seed, device=dev, rules=tp_rules, mesh=mesh)
        model = api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh)
        loss0, g0 = step_mod._grads_of(api.train_loss_fn(cfg, tp_rules, mesh), base, batch, mb)
        g0 = api.global_leaves(base, g0)
        model.tp.reset()
        model.fsdp.reset()
        loss1, g1 = step_mod._grads_of(api.train_loss_fn(cfg, rules, mesh), model, batch, mb)
        g1 = api.global_leaves(model, g1)
        tcalls = lm.tp_calls(cfg, "train", rows // mb // groups, text, size) * mb
        fcalls = lm.fsdp_calls(cfg, "train", mesh, rules) * mb
        grad_tp = tp_bytes_check("FSDP gradient's model axis", model, tcalls, ordered=False)
        grad_fs = fsdp_bytes_check("FSDP gradient", model, fcalls, ordered=False)
        errs = leaf_rel_errs(g1, g0)
        loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        del g0, g1
        gc.collect()
        torch.cuda.empty_cache()
        worst = worst_leaf(errs)
        over = {k: e for k, e in errs.items() if not e <= TPF_LEAF_TOL.get(k, TP_REL_TOL)}
        if not loss_err <= TP_REL_TOL or over:
            raise AssertionError(f"{cfg.name} FSDP step: loss rel err {loss_err:.3g}, leaves "
                                 f"over their bound: {over}")
        sa, sb = (optim.get(cfg.optimizer).init(m) for m in (base, model))
        fa = step_mod.build_train_step(cfg, mesh=mesh, rules=tp_rules, microbatches=mb,
                                       lr_kw=TRAIN_LR)
        fb = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, microbatches=mb,
                                       lr_kw=TRAIN_LR)
        base, sa, ma = fa(base, sa, batch, 1)
        model.tp.reset()
        model.fsdp.reset()
        model, sb, mb_ = fb(model, sb, batch, 1)
        step_tp = tp_bytes_check("FSDP step's model axis", model,
                                 tcalls + optim.tp_calls(model), ordered=False)
        step_fs = fsdp_bytes_check("FSDP step", model, fcalls + optim.fsdp_calls(model),
                                   ordered=False)
        want = {p: torch.from_numpy(np.asarray(v, np.float32)) for p, v in
                _flat_items(api.to_reference(base))}
        got = {p: torch.from_numpy(np.asarray(v, np.float32)) for p, v in
               _flat_items(api.to_reference(model))}
        perrs = leaf_rel_errs(_tree_of(got), _tree_of(want))
        pworst = worst_leaf(perrs)
        if perrs[pworst] > TP_REL_TOL:
            raise AssertionError(f"{cfg.name} FSDP step: parameter {pworst} after the "
                                 f"update {perrs[pworst]:.3g} > {TP_REL_TOL}")
    res = dict(arch=cfg.name, layers=cfg.n_layers, mesh=mesh_sizes, rows=rows, seq=seq,
               microbatches=mb, optimizer=cfg.optimizer,
               loss=float(loss0), loss_rel_err=loss_err, worst_leaf=worst,
               worst_rel_err=errs[worst], params_worst_leaf=pworst,
               params_worst_rel_err=perrs[pworst], grad_fsdp_bytes_per_rank=grad_fs,
               grad_tp_bytes_per_rank=grad_tp, step_fsdp_bytes_per_rank=step_fs,
               step_tp_bytes_per_rank=step_tp, fsdp_calls=len(fcalls),
               step_loss=float(mb_["loss"]), tp_step_loss=float(ma["loss"]),
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  {cfg.name} float32 (TF32 off) {cfg.n_layers}-layer cut on "
        f"{dict(zip(mesh_sizes[1], mesh_sizes[0]))}, {rows} x {seq} tokens in {mb} "
        f"microbatches, FSDP rules against the tensor-parallel step: loss {float(loss1):.6f} "
        f"(tensor-parallel {float(loss0):.6f}, rel err {loss_err:.2e}), every leaf's gradient "
        f"within {errs[worst]:.2e} of its largest (worst {worst}), after {cfg.optimizer} every "
        f"parameter within {perrs[pworst]:.2e} (worst {pworst}); {len(fcalls)} FSDP calls "
        f"== the byte model (remat's recompute included), {grad_fs / 1e9:.3f} GB a rank, the "
        f"whole step {step_fs / 1e9:.3f} GB (model axis {step_tp / 1e9:.3f} GB); peak "
        f"{res['peak_bytes'] / 1e9:.2f} GB")
    del base, model, sa, sb
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tree_of(flat):
    """A nested dict of ``{path: leaf}``."""
    from repro_torch.dist.sharding import tree_set

    out = {}
    for p, v in flat.items():
        tree_set(out, p, v)
    return out


def fsdp_train(dev, seed, cfg=None, shape=None, plain=True):
    """(b) ``cfg`` (deepseek-7b at full width cut to FSDP_TRAIN_LAYERS
    layers by default) on (data 2, model 4), ``shape`` = (steps, rows,
    tokens, microbatches) (FSDP_TRAIN_STEPS bfloat16 steps of
    FSDP_TRAIN_BATCH x FSDP_TRAIN_SEQ in the config's microbatches by
    default) through ``train.loop.train`` (remat, the config's optimizer,
    the GSPMD step), unsharded first where ``plain``, then tensor-parallel
    alone, then with FSDP rules: every loss finite, the FSDP run's first
    bit-equal to the tensor-parallel run's and the others within
    FSDP_LOSS_TOL of them (the clip's norm sums the shards in another
    order), and each within FSDP_LOSS_TOL of the unsharded run's; step ms
    of each, tokens a second, 6ND against the bfloat16 peak, peak
    memory."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
    from repro_torch.models import api
    from repro_torch.train import loop

    if cfg is None:
        cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=FSDP_TRAIN_LAYERS)
    steps, rows_n, seq, mb = shape or (FSDP_TRAIN_STEPS, FSDP_TRAIN_BATCH, FSDP_TRAIN_SEQ,
                                       cfg.train_microbatches)
    mesh = SimMesh(*TP_MESH)
    runs = {}
    kinds = [("plain", None, None)] if plain else []
    kinds += [("tp", mesh, rules_for_mesh(mesh)), ("fsdp", mesh, rules_for_mesh(mesh, fsdp=True))]
    for name, on, rules in kinds:
        torch.cuda.reset_peak_memory_stats()
        rows = []
        t0 = time.perf_counter()
        out = loop.train(cfg, rows_n, seq,
                         loop.LoopConfig(n_steps=steps, microbatches=mb, lr_kw=TRAIN_LR,
                                         log_every=steps),
                         seed=seed, on_metrics=lambda s, m, rows=rows: rows.append(m),
                         device=dev, mesh=on, rules=rules)
        if (getattr(out["params"], "fsdp", None) is not None) != (name == "fsdp"):
            raise AssertionError(f"train.loop.train did not take the {name} step")
        step_s = [r["step_time"] for r in rows]
        runs[name] = dict(losses=out["losses"], step_s=step_s,
                          step_s_median=float(np.median(step_s[1:] or step_s)),
                          peak_bytes=torch.cuda.max_memory_allocated(),
                          wall_s=time.perf_counter() - t0)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    got, want = np.asarray(runs["fsdp"]["losses"]), np.asarray(runs["tp"]["losses"])
    rel = np.abs(got - want) / np.abs(want)
    if not (np.isfinite(got).all() and got[0] == want[0] and rel.max() <= FSDP_LOSS_TOL):
        raise AssertionError(f"{cfg.name} FSDP training: losses {got.tolist()} against the "
                             f"tensor-parallel run's {want.tolist()}")
    plain_rel = None
    if plain:
        ref = np.asarray(runs["plain"]["losses"])
        plain_rel = float(max((np.abs(x - ref) / np.abs(ref)).max() for x in (got, want)))
        if not (np.isfinite(ref).all() and plain_rel <= FSDP_LOSS_TOL):
            raise AssertionError(f"{cfg.name} training: FSDP losses {got.tolist()} and "
                                 f"tensor-parallel {want.tolist()} against the unsharded "
                                 f"run's {ref.tolist()}")
    med = runs["fsdp"]["step_s_median"]
    tokens = rows_n * seq
    n_params = api.param_counts(cfg)["total"]
    flops = api.model_flops(cfg, configs.ShapeConfig("smoke", seq, rows_n, "train"))
    res = dict(runs["fsdp"], arch=cfg.name, layers=cfg.n_layers, params=n_params,
               mesh=TP_MESH, steps=steps, batch=rows_n, seq=seq, microbatches=mb,
               optimizer=cfg.optimizer, tokens_per_s=tokens / med, model_flops=flops,
               peak_share=flops / med / H100_BF16_FLOPS, loss_rel_err=float(rel.max()),
               plain_loss_rel_err=plain_rel, tp=runs["tp"], plain=runs.get("plain"))
    tp_med = runs["tp"]["step_s_median"]
    unsharded = ""
    if plain:
        unsharded = (f"; unsharded {', '.join(f'{x:.4f}' for x in runs['plain']['losses'])} "
                     f"(within {plain_rel:.2e}; step {runs['plain']['step_s_median'] * 1e3:.1f} "
                     f"ms, peak {runs['plain']['peak_bytes'] / 1e9:.2f} GB)")
    log(f"  {cfg.name} cut to {cfg.n_layers} layers ({n_params:,} parameters, {cfg.optimizer}) "
        f"on data 2 x model 4: {steps} steps of {rows_n} x {seq} tokens in {mb} microbatches, "
        f"losses {', '.join(f'{x:.4f}' for x in got)} (tensor-parallel alone "
        f"{', '.join(f'{x:.4f}' for x in want)}, within {rel.max():.2e}{unsharded}); step "
        f"{med * 1e3:.1f} ms median of steps 2-{steps} (first "
        f"{runs['fsdp']['step_s'][0] * 1e3:.1f} ms; tensor-parallel alone {tp_med * 1e3:.1f} "
        f"ms), {tokens / med:,.0f} tokens/s, 6ND {res['peak_share']:.1%} of the bf16 peak; "
        f"peak {res['peak_bytes'] / 1e9:.2f} GB (tensor-parallel alone "
        f"{runs['tp']['peak_bytes'] / 1e9:.2f}); {res['wall_s']:.1f} s")
    return res


def fsdp_gloo(dev, seed):
    """(c) one FSDP GSPMD step in TP_GLOO_WORLD gloo processes on the card
    on (data 2, model 2), the 2-layer cut of deepseek-7b in float32,
    against the simulated ranks: each process holds its data and model
    ranks' blocks, its records equal the simulated ranks', every leaf of
    the gradient within TP_REL_TOL; each process's peak logged."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=RESTART_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    job = dict(parts=("step",), step_cfg=cfg, step_kind="gspmd", mesh=TP_GLOO_MESH,
               batch=FSDP_GLOO_BATCH, seq=FSDP_GLOO_SEQ, fsdp=True)
    return tp_group(dev, seed, job, TP_GLOO_WORLD, "gloo")


def run_fsdp(dev, seed, serve=True, train=True, gloo=True):
    """Phase 3g: FSDP beside tensor parallelism (module docstring, item
    3g). The graph kernels are not on this path: their counts stay 0.
    ``gloo=False`` leaves (c) to the caller (:func:`gloo_phases`)."""
    import torch

    from repro_torch.kernels import build

    build.reset_launches()
    out = {}
    t0 = time.perf_counter()
    if serve:
        out["serve"] = fsdp_serve(dev, seed)
    if train:
        out["step"] = fsdp_step_check(dev, seed)
        out["train"] = fsdp_train(dev, seed)
    if gloo:
        out["gloo"] = fsdp_gloo(dev, seed)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"phase 3g launched graph kernels: {launched}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 3g launched none of the four graph kernels; {out['seconds']:.1f} s")
    gc.collect()
    if dev.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return out


class CardWatch:
    """``nvidia-smi``'s memory.used of ``dev``'s card every ``every`` s in
    a thread (none off the card, or without ``nvidia-smi``); ``take()``
    returns the most MiB seen since the last ``take()`` (None if none)."""

    def __init__(self, dev, every=0.5):
        self.peak = self.total = None
        self.done = threading.Event()
        self.thread = None
        if dev.type == "cuda":
            self.thread = threading.Thread(target=self.run, args=(dev.index or 0, every),
                                           daemon=True)
            self.thread.start()

    def run(self, index, every):
        cmd = ["nvidia-smi", "-i", str(index), "--query-gpu=memory.used,memory.total",
               "--format=csv,noheader,nounits"]
        while not self.done.is_set():
            try:
                text = subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout
                used, self.total = (int(x) for x in text.split(","))
            except (OSError, ValueError, subprocess.SubprocessError):
                return
            self.peak = used if self.peak is None else max(self.peak, used)
            self.done.wait(every)

    def take(self):
        peak, self.peak = self.peak, None
        return peak

    def stop(self):
        self.done.set()
        if self.thread is not None:
            self.thread.join()


def gloo_phases(dev, seed):
    """Phases 3c(d), 3e(d) and 3g(c), one after the other: their processes hold
    the card while this process does only host work (the default run
    starts them beside phase 4's ETL, which places nothing on the card
    until they have ended). Each records the most of the card in use
    while it ran (``card_used_mib``, of ``card_total_mib``)."""
    log(f"[3c/27 (d) and 3e/27 (d)] the gradient sync and the tensor-parallel "
        f"butterfly step in {DIST_WORLD} gloo processes each, beside phase 4's host work; "
        f"then [3g/27 (c)] the FSDP GSPMD step in {TP_GLOO_WORLD} gloo processes")
    watch = CardWatch(dev)
    try:
        out = {"dist": dist_sync(dev, seed)}
        out["dist"]["card_used_mib"] = watch.take()
        out["gloo"] = tp_gloo(dev, seed)
        out["gloo"]["card_used_mib"] = watch.take()
        out["fsdp"] = fsdp_gloo(dev, seed)
        out["fsdp"]["card_used_mib"] = watch.take()
    finally:
        watch.stop()
    for key in ("dist", "gloo", "fsdp"):
        out[key]["card_total_mib"] = watch.total
    if watch.total is not None:
        log(f"  the card's memory in use (nvidia-smi, every 0.5 s): at most "
            f"{out['dist']['card_used_mib']} MiB in 3c(d), {out['gloo']['card_used_mib']} "
            f"MiB in 3e(d), {out['fsdp']['card_used_mib']} MiB in 3g(c), of {watch.total} MiB")
    return out


def tp_multi_card(dev, seed, world, backend="nccl"):
    """``--multi-card``'s phase 3e: (a) serving and (b) a float32 train step
    over nccl, one model rank a card on (data 1, model ``world``), against
    the simulated ranks on card 0 (``backend`` gloo rehearses it on the
    CPU)."""
    from repro_torch import configs

    base = configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=RESTART_LAYERS, param_dtype="float32",
                     compute_dtype="float32")
    job = dict(parts=("serve", "step"), serve_cfg=base, serve_batch=LM_BATCH,
               serve_prompt=TP_PROMPT, serve_new=TP_NEW, step_cfg=cfg, step_kind="gspmd",
               mesh=((1, world), ("data", "model")), batch=TRAIN_BATCH // 4, seq=TRAIN_SEQ)
    return tp_group(dev, seed, job, world, backend)


def fsdp_multi_card(dev, seed, world, backend="nccl"):
    """``--multi-card``'s phase 3g: one FSDP GSPMD step over nccl (its
    gradient reduce-scattered by ``dist.reduce_scatter_tensor``), one rank
    a card on (data 2, model ``world`` / 2), the 2-layer cut in float32,
    against the simulated ranks on card 0 (``backend`` gloo rehearses it
    on the CPU)."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=RESTART_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    job = dict(parts=("step",), step_cfg=cfg, step_kind="gspmd",
               mesh=((2, world // 2), ("data", "model")), batch=FSDP_GLOO_BATCH,
               seq=FSDP_GLOO_SEQ, fsdp=True)
    return tp_group(dev, seed, job, world, backend)


def run_multi_card_phases(args, dev, phase, world, out):
    """``--multi-card``'s phases into ``out``: 3c(d) over nccl, then
    ``launch.train`` under ``torchrun``, then 3e's and 3g's steps over
    nccl."""
    phase(f"[3c(d)/27] the gradient sync over nccl, one rank on each of {world} cards")
    out["dist"] = dist_sync(dev, args.seed, backend="nccl", world=world)
    phase(f"[3c(d)/27] launch.train under torchrun, {world} processes, nccl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(world), "-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--smoke",
         "--steps", "3", "--grad-sync", "butterfly", "--backend", "nccl"],
        env=env, capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
    out["cli_s"] = time.perf_counter() - t0
    done = [ln for ln in run.stdout.splitlines() if ln.startswith("done:")]
    if run.returncode or len(done) != 1:
        raise AssertionError(f"torchrun launch.train: rc {run.returncode}, {done}, "
                             f"{run.stderr[-3000:]}")
    log(f"  {done[0]} ({out['cli_s']:.1f} s)")
    phase(f"[3e/27] serving and a float32 train step over nccl, one model rank on each "
          f"of {world} cards")
    out["tp"] = tp_multi_card(dev, args.seed, world)
    phase(f"[3g/27] an FSDP float32 train step over nccl, one rank on each of {world} cards")
    out["fsdp"] = fsdp_multi_card(dev, args.seed, world)


def run_multi_card(args, dev, card, phase, t_start) -> int:
    """``--multi-card``: phase 3c(d) over nccl, one rank on each card, then
    ``launch.train`` under ``torchrun`` with nccl on as many processes,
    then phase 3e's serving and step over nccl (``tp_multi_card``), then
    phase 3g's FSDP step over nccl (``fsdp_multi_card``); with ``--coverage
    lm``, the four families' serving over nccl (``tpf_multi_card``)
    alone."""
    import torch

    world = torch.cuda.device_count()
    if world < 2:
        raise AssertionError(f"--multi-card needs several cards, found {world}")
    out = {"cards": subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()}
    for line in out["cards"]:
        log(f"  card {line}")
    if args.coverage == "lm":
        phase(f"[coverage lm, group 5] the four families' serving over nccl, one model rank "
              f"on each of {world} cards")
        out["families"] = tpf_multi_card(dev, args.seed, world)
    else:
        run_multi_card_phases(args, dev, phase, world, out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           multi_card=out, total_s=time.perf_counter() - t_start,
                           args=vars(args)), f, indent=1, default=float)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# --coverage lm: the LM side's paths that the default run leaves out
# ---------------------------------------------------------------------------

# group 1, FSDP for the other families on TP_MESH beside tensor parallelism
# alone; each cut only in depth, expert count or batch (PERF.md section 4
# reckons the bytes): qwen3-moe at 2 of 94 layers (128 experts each),
# serving (prompts, prompt tokens, greedy tokens) and bfloat16 steps under
# Adafactor (steps, rows, tokens, microbatches)
COV_MOE_ARCH, COV_MOE_LAYERS = "qwen3-moe-235b-a22b", 2
COV_MOE_SERVE, COV_MOE_TRAIN = (8, 256, 16), (3, 4, 512, 2)
# its steps at one layer: at two, Adafactor's float32 passes over a
# [2, 128, 4096, 1536] expert leaf (6.4 GB each) beside the float32
# gradient (24.9 GB) left the card 3.7 GB short
COV_MOE_TRAIN_LAYERS = 1
# gemma3-27b at one 5-local + 1-global period, its prompts past the
# 1024-token window, served with the defaults and with the ring cache and
# the in-place decode
COV_GEMMA_ARCH, COV_GEMMA_LAYERS = "gemma3-27b", 6
COV_GEMMA_SERVE, COV_GEMMA_TRAIN = (2, 2048, 32), (2, 2, 1056, 1)
# its steps at two (local) layers, past the window: at six, AdamW's float32
# passes over the tied 262,144 x 5,376 embedding (5.6 GB each) beside the
# moments (31 GB) and the float32 gradient (15.5 GB) left the card short
COV_GEMMA_TRAIN_LAYERS = 2
# kimi-k2 at its dense first layer and one MoE layer, serving only (its
# Adafactor step is qwen3-moe's path), its experts cut 384 -> 192: a leaf is
# drawn whole in float32 (the 384-expert leaf 22.5 GB) beside the 40 GB
# model, and the FSDP run gathers the MoE layer whole (33.8 GB) beside it
COV_KIMI_ARCH, COV_KIMI_LAYERS, COV_KIMI_SERVE = "kimi-k2-1t-a32b", 2, (8, 256, 16)
COV_KIMI_EXPERTS = 192
# 3f's cuts: jamba's serving only (its float32 step at one period is 53 GB
# of parameters alone), the float32 steps of internvl2 and whisper
COV_FSDP_SERVE = {"jamba-v0.1-52b": (4, 512, 16), "internvl2-26b": (8, 256, 16),
                  "whisper-medium": (8, 256, 16)}
COV_FSDP_STEP = {"internvl2-26b": (4, 256, 2), "whisper-medium": (4, 256, 2)}
# group 2, FSDP state on deepseek-7b's 2-layer cut: bfloat16 (rows, tokens,
# microbatches), (steps, fail at, checkpoint every), the restore's mesh and
# the pod x data mesh
COV_STATE_SHAPE, COV_STATE_PLAN = (4, 512, 2), (3, 2, 2)
COV_STATE_RESTORE = (("data 8, fsdp", (8,), ("data",), True),)
COV_POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
# group 3, the four families beyond serving at 3f's cuts; jamba's experts
# cut from 16 to COV_JAMBA_EXPERTS for its steps (one 8-layer period with
# AdamW in bfloat16 is 13.3 G parameters x 16 B, 213 GB)
COV_FAMILIES = ("mamba2-130m", "jamba-v0.1-52b", "internvl2-26b", "whisper-medium")
COV_JAMBA_EXPERTS = 2
COV_FAMILY_STEP = {"mamba2-130m": (4, 1024, 2), "jamba-v0.1-52b": (4, 512, 2),
                   "internvl2-26b": (4, 256, 2), "whisper-medium": (4, 256, 2)}
COV_FAMILY_PLAN = (3, 2, 2)
# jamba's steps on (data 2, model 2), one of its 2 experts a model rank: on
# model 4 its expert leaves replicate, and the butterfly step's stacked rows
# of one (8 x 1.9 GB in float32, and as much again to merge) beside both
# data groups' gradients and the synced one overran the card
COV_FAMILY_MESH = {"jamba-v0.1-52b": ((2, 2), ("data", "model"))}
# jamba's bfloat16 training unsharded (sharded, the GSPMD step holds each
# data group's float32 gradient, 2 x 13.6 GB, and the clip's copy beside the
# bfloat16 weights and AdamW's moments, 34 GB: 78 GB) and without its
# restart (its 34 GB checkpoint took 199 s to restore: over the time a run
# is given)
COV_UNSHARDED_TRAIN = ("jamba-v0.1-52b",)
# the gloo family group: whisper's serving and mamba2's GSPMD step in
# TP_GLOO_WORLD processes on TP_GLOO_MESH
COV_GLOO_SERVE = (4, 64, 8)
COV_GLOO_STEP = (4, 256)
# group 4: serve_lm's greedy tokens, launch.train's butterfly losses, the
# prefill's flop count
COV_SERVE_LM_NEW = 8
COV_TRAIN_CLI = ("--arch", "olmo-1b", "--smoke", "--steps", "3", "--grad-sync", "butterfly",
                 "--ranks", "4")
COV_SYNC_MESH = ((2, 2), ("pod", "data"))
COV_SYNC_LEAVES = ((2048, 2048), (2048, 6144), (6144,), (1000, 3))
COV_PREFILL = (8, 512)
# the LM coverage groups, in the order a user meets them
LM_GROUPS = ("loss", "fsdp", "state", "families", "other")


def cov_family_config(arch, dtype=None, train=False):
    """3f's cut of ``arch`` (``tpf_config``), jamba's experts cut to
    COV_JAMBA_EXPERTS for ``train``."""
    cfg = tpf_config(arch, dtype)
    if train and cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_experts=COV_JAMBA_EXPERTS)
    return cfg


def cov_loss(dev, seed):
    """Group 0: phase 3g(b)'s steps (deepseek-7b at full width cut to
    FSDP_TRAIN_LAYERS layers) unsharded, tensor-parallel and with FSDP
    rules: the losses of each sharded run within FSDP_LOSS_TOL of the
    unsharded run's (:func:`fsdp_train`)."""
    out = fsdp_train(dev, seed, plain=True)
    losses = out["plain"]["losses"]
    log(f"  unsharded losses {', '.join(f'{x:.4f}' for x in losses)} at TRAIN_LR "
        f"{TRAIN_LR}: the sharded runs within {out['plain_loss_rel_err']:.2e} of them")
    return out


def cov_fsdp(dev, seed):
    """Group 1: FSDP for qwen3-moe (serving, bfloat16 steps under
    Adafactor), gemma3 (serving with the defaults and with the ring cache
    and in-place decode, the two runs' tokens equal; steps), kimi-k2
    (serving, the two models apart), and jamba, internvl2 and whisper at
    3f's cuts (serving; the float32 step of the two that fit)."""
    from repro_torch import configs

    out = {}
    moe = dataclasses.replace(configs.get_config(COV_MOE_ARCH), n_layers=COV_MOE_LAYERS)
    out["qwen3-moe serve"] = fsdp_serve(dev, seed, moe, COV_MOE_SERVE)
    out["qwen3-moe train"] = fsdp_train(dev, seed, dataclasses.replace(
        moe, n_layers=COV_MOE_TRAIN_LAYERS), COV_MOE_TRAIN, plain=False)
    gemma = dataclasses.replace(configs.get_config(COV_GEMMA_ARCH), n_layers=COV_GEMMA_LAYERS)
    if gemma.local_window >= COV_GEMMA_SERVE[1]:
        raise AssertionError(f"gemma3's prompts ({COV_GEMMA_SERVE[1]}) do not pass its "
                             f"window ({gemma.local_window})")
    plain, ring = {}, {}
    out["gemma3 serve"] = fsdp_serve(dev, seed, gemma, COV_GEMMA_SERVE, keep=plain)
    out["gemma3 serve ring"] = fsdp_serve(
        dev, seed, dataclasses.replace(gemma, ring_local_cache=True, decode_inplace=True),
        COV_GEMMA_SERVE, keep=ring)
    if not (plain["tokens"] == ring["tokens"]).all():
        raise AssertionError("gemma3: the ring cache's greedy tokens differ from the full "
                             "cache's")
    log(f"  gemma3: ring_local_cache + decode_inplace gives the same "
        f"{plain['tokens'].size} greedy tokens as the full cache, past the "
        f"{gemma.local_window}-token window")
    out["gemma3 train"] = fsdp_train(dev, seed, dataclasses.replace(
        gemma, n_layers=COV_GEMMA_TRAIN_LAYERS), COV_GEMMA_TRAIN, plain=False)
    kimi = dataclasses.replace(configs.get_config(COV_KIMI_ARCH), n_layers=COV_KIMI_LAYERS,
                               n_experts=COV_KIMI_EXPERTS)
    out["kimi-k2 serve"] = fsdp_serve(dev, seed, kimi, COV_KIMI_SERVE, apart=True)
    for arch, shape in COV_FSDP_SERVE.items():
        cfg = tpf_config(arch)
        out[f"{arch} serve"] = fsdp_serve(dev, seed, cfg, shape, apart=cfg.family == "hybrid")
        if arch in COV_FSDP_STEP:
            out[f"{arch} step"] = fsdp_step_check(dev, seed, tpf_config(arch, "float32"),
                                                  COV_FSDP_STEP[arch])
    return out


def cov_state(dev, seed, tmp):
    """Group 2, on deepseek-7b's 2-layer cut: a bfloat16 run with FSDP
    rules failed and restarted from its checkpoint, bit-equal to the
    uninterrupted run; that checkpoint restored onto data 8 with FSDP;
    the float32 step with FSDP over pod and data (COV_POD_MESH) against
    tensor parallelism alone on the same mesh, its loss against the (data
    2, model 4) step's on the same batch (twice FSDP_STEP's rows)."""
    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh

    cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=RESTART_LAYERS)
    mesh = SimMesh(*TP_MESH)
    out = {"restart": restart_check(dev, seed, tmp, cfg, COV_STATE_SHAPE, COV_STATE_PLAN, mesh,
                                    rules_for_mesh(mesh, fsdp=True), async_save=False)}
    out["restore"] = elastic_restore(dev, os.path.join(tmp, "ck"), cfg, COV_STATE_RESTORE)
    shutil.rmtree(os.path.join(tmp, "ck"), ignore_errors=True)
    rows, seq, mb = FSDP_STEP
    shape = (rows * 2, seq, mb)  # a row a microbatch for each of pod x data's 4 groups
    out["step"] = fsdp_step_check(dev, seed, shape=shape)
    out["pod_step"] = fsdp_step_check(dev, seed, shape=shape, mesh_sizes=COV_POD_MESH)
    err = abs(out["pod_step"]["loss"] - out["step"]["loss"]) / abs(out["step"]["loss"])
    if not err <= TP_REL_TOL:
        raise AssertionError(f"pod x data FSDP: loss {out['pod_step']['loss']} against data 2 "
                             f"x model 4's {out['step']['loss']}")
    out["pod_loss_rel_err"] = err
    log(f"  pod x data x model FSDP step's loss within {err:.2e} of data 2 x model 4's")
    return out


def cov_butterfly_step(arch, dev, seed):
    """The butterfly step (``build_train_step_butterfly``, the model axis
    inside) of ``arch`` in float32 on TP_MESH (or its COV_FAMILY_MESH)
    against its GSPMD step from
    the same weights and batch: the loss within TP_REL_TOL, every leaf of
    the clipped gradient the optimizer takes within TP_REL_TOL of its
    largest (TPF_LEAF_TOL's leaves their own), the butterfly's bytes a
    rank equal to the byte model. The
    optimizer is held (it keeps the gradient and moves nothing): the two
    steps start from one state."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh, sorted_leaves
    from repro_torch.models import api
    from repro_torch.train import optim, step as step_mod

    cfg = cov_family_config(arch, "float32", train=True)
    mesh = SimMesh(*COV_FAMILY_MESH.get(arch, TP_MESH))
    rules = rules_for_mesh(mesh)
    groups = mesh.shape["data"]
    b, text, mb = COV_FAMILY_STEP[arch]
    seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = device_batch(SyntheticLM(cfg, b, seq), 1, dev)
    torch.cuda.reset_peak_memory_stats()
    res, got = {"arch": arch, "layers": cfg.n_layers, "experts": cfg.n_experts,
                "mesh": mesh.sizes}, {}
    with exact_float32():
        model = api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh)
        real = optim.get(cfg.optimizer)
        for kind in ("gspmd", "butterfly"):
            caught = {}

            def keep(m, grads, st, lr, caught=caught):
                caught["grads"] = grads
                return m, st

            get, optim.get = optim.get, lambda _name: dataclasses.replace(real, apply=keep)
            try:
                if kind == "gspmd":
                    fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules, microbatches=mb,
                                                   lr_kw=TRAIN_LR)
                else:
                    fn = step_mod.build_train_step_butterfly(cfg, mesh, rules, microbatches=mb,
                                                             lr_kw=TRAIN_LR)
            finally:
                optim.get = get
            model.tp.reset()
            t0 = time.perf_counter()
            _, _, met = fn(model, {}, batch, 1)
            torch.cuda.synchronize()
            res[f"{kind}_s"] = time.perf_counter() - t0
            # the step's bytes a rank less the model axis's: the gradient sync's
            got[kind] = dict(loss=float(met["loss"]), bytes=int(met.get("bytes_per_rank", 0))
                             - int(model.tp.bytes_sent[0]))
            if kind == "butterfly":
                axis = optim.shard_axes(model)
                want_bytes = sum(collectives.grad_sync_bytes(
                    "butterfly", groups, 2,
                    g.numel() if axis[p] is None else g.numel() // g.shape[axis[p]],
                    g.element_size()) for p, g in sorted_leaves(caught["grads"]))
            got[kind]["grads"] = {p: g.cpu() for p, g in
                                  sorted_leaves(api.global_leaves(model, caught.pop("grads")))}
        del model
    gc.collect()
    torch.cuda.empty_cache()
    errs = leaf_rel_errs(_tree_of(got["butterfly"]["grads"]), _tree_of(got["gspmd"]["grads"]))
    worst = worst_leaf(errs)
    over = {k: e for k, e in errs.items() if not e <= TPF_LEAF_TOL.get(k, TP_REL_TOL)}
    loss_err = abs(got["butterfly"]["loss"] - got["gspmd"]["loss"]) / abs(got["gspmd"]["loss"])
    if not loss_err <= TP_REL_TOL or over:
        raise AssertionError(f"{arch} butterfly step: loss rel err {loss_err:.3g}, leaves over "
                             f"their bound: {over}")
    if got["butterfly"]["bytes"] != want_bytes:
        raise AssertionError(f"{arch} butterfly step: {got['butterfly']['bytes']} B a rank, "
                             f"the byte model {want_bytes}")
    res.update(loss=got["gspmd"]["loss"], loss_rel_err=loss_err, worst_leaf=worst,
               worst_rel_err=errs[worst], sync_bytes_per_rank=want_bytes,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  {arch} ({cfg.n_layers} layers{', %d experts' % cfg.n_experts if cfg.n_experts else ''}"
        f") float32 butterfly step on data {groups} x model {mesh.shape['model']}, {b} x {seq} "
        f"tokens in {mb} microbatches, against the GSPMD step: loss {got['butterfly']['loss']:.6f}"
        f" (GSPMD {got['gspmd']['loss']:.6f}, rel err {loss_err:.2e}), every leaf of the "
        f"clipped gradient within {errs[worst]:.2e} (worst {worst}); "
        f"the sync's {want_bytes / 1e9:.4f} GB a rank == the byte model; "
        f"{res['gspmd_s']:.1f} s / {res['butterfly_s']:.1f} s; peak "
        f"{res['peak_bytes'] / 1e9:.2f} GB")
    return res


def cov_families(dev, seed, tmp):
    """Group 3: each family's butterfly step against its GSPMD step, its
    bfloat16 run on TP_MESH failed and restarted bit-equal (jamba's, its
    experts cut, unsharded and not restarted, is its training through
    ``train.loop.train``), whisper's
    float32 serving and step with its 16 kv heads split 4 a rank on model
    4 (:func:`tpf_float32`), then the gloo family group: whisper's serving
    and mamba2's GSPMD step in TP_GLOO_WORLD processes on the card against
    the simulated ranks."""
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh

    out = {}
    for arch in COV_FAMILIES:
        out[f"{arch} butterfly"] = cov_butterfly_step(arch, dev, seed)
        b, text, mb = COV_FAMILY_STEP[arch]
        cfg = cov_family_config(arch, train=True)
        seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
        apart = arch in COV_UNSHARDED_TRAIN
        mesh = None if apart else SimMesh(*TP_MESH)
        out[f"{arch} {'train' if apart else 'restart'}"] = restart_check(
            dev, seed, tmp, cfg, (b, seq, mb), COV_FAMILY_PLAN, mesh,
            None if mesh is None else rules_for_mesh(mesh), async_save=False,
            restart=not apart)
        shutil.rmtree(os.path.join(tmp, "ck"), ignore_errors=True)
    whisper, mesh = tpf_config("whisper-medium"), SimMesh(*TP_MESH)
    if whisper.n_kv_heads % mesh.shape["model"] or whisper.n_kv_heads < mesh.shape["model"]:
        raise AssertionError("whisper's kv heads do not split on the model axis")
    out["whisper split kv"] = tpf_float32("whisper-medium", dev, seed)
    out["gloo"] = cov_gloo_families(dev, seed)
    return out


def cov_gloo_families(dev, seed, world=TP_GLOO_WORLD, backend="gloo", mesh=TP_GLOO_MESH):
    """The gloo family group: whisper's serving (float32 prefill logits and
    greedy tokens) and mamba2's float32 GSPMD step in ``world`` processes
    on ``mesh`` against the simulated ranks (:func:`tp_group`)."""
    b, p, new = COV_GLOO_SERVE
    rows, seq = COV_GLOO_STEP
    job = dict(parts=("serve", "step"), serve_cfg=tpf_config("whisper-medium"),
               serve_batch=b, serve_prompt=p, serve_new=new,
               step_cfg=tpf_config("mamba2-130m", "float32"), step_kind="gspmd", mesh=mesh,
               batch=rows, seq=seq)
    return tp_group(dev, seed, job, world, backend)


def tpf_multi_card(dev, seed, world, backend="nccl"):
    """``--coverage lm --multi-card``: 3f's four families' serving over
    ``backend``, one model rank a card on (data 1, model ``world``), each
    process's float32 prefill logits, greedy tokens and record against the
    simulated ranks on card 0 (jamba's experts cut: its float32 period does
    not fit twice on card 0)."""
    out = {}
    for arch in COV_FAMILIES:
        cfg = cov_family_config(arch, train=True)
        _, b, p, new = TPF_SERVE[arch]
        job = dict(parts=("serve",), serve_cfg=cfg, serve_batch=b, serve_prompt=p,
                   serve_new=new, mesh=((1, world), ("data", "model")))
        out[arch] = tp_group(dev, seed, job, world, backend)
    return out


def cli_lines(main, argv):
    """``main(argv)`` in this process, its standard output's lines; raises
    on a non-zero exit."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    if rc:
        raise AssertionError(f"{main.__module__} {' '.join(argv)}: exit {rc}")
    return buf.getvalue().splitlines()


def cov_serve_lm(dev):
    """``repro_torch.launch.serve_lm`` for every arch's reduced config on the
    card and with ``--device cpu``, greedy: the printed tokens equal (TF32
    off)."""
    from repro_torch import configs
    from repro_torch.launch import serve_lm

    out = {}
    for arch in configs.ARCH_NAMES:
        argv = ["--arch", arch, "--temperature", "0", "--new", str(COV_SERVE_LM_NEW)]
        toks = {}
        t0 = time.perf_counter()
        with exact_float32():
            for name in (dev.type, "cpu"):
                lines = cli_lines(serve_lm.main, argv + ["--device", name])
                toks[name] = next(ln for ln in lines if ln.startswith("sample token ids:"))
        if toks[dev.type] != toks["cpu"]:
            raise AssertionError(f"serve_lm --arch {arch}: {toks[dev.type]} on the card, "
                                 f"{toks['cpu']} on the CPU")
        out[arch] = dict(tokens=toks["cpu"].split(":", 1)[1].strip(),
                         seconds=time.perf_counter() - t0)
    log(f"  serve_lm on the card == --device cpu (greedy, {COV_SERVE_LM_NEW} tokens) for all "
        f"{len(out)} archs: {', '.join(out)}")
    return out


def cov_train_cli(dev):
    """``repro_torch.launch.train`` with ``--grad-sync butterfly`` over 4
    simulated ranks on the card against the same command with the
    one-device step (``--grad-sync xla``): the printed losses (the logged
    step's, the first and the last) within their printed precision (TF32
    off)."""
    import re

    from repro_torch.launch import train

    losses = {}
    with exact_float32():
        for sync in ("butterfly", "xla"):
            argv = [a if a != "butterfly" else sync for a in COV_TRAIN_CLI]
            lines = cli_lines(train.main, argv + ["--device", dev.type])
            losses[sync] = [float(x) for ln in lines for m in re.findall(
                r"^step +\d+ loss ([0-9.]+)|^done: first loss ([0-9.]+) -> last ([0-9.]+)", ln)
                for x in m if x]
    got, want = losses["butterfly"], losses["xla"]
    if len(want) != 3 or len(got) != 3 or max(abs(a - b) for a, b in zip(got, want)) > 1e-4 \
            or not all(math.isfinite(x) for x in got):
        raise AssertionError(f"launch.train --grad-sync butterfly: {losses}")
    log(f"  launch.train {' '.join(COV_TRAIN_CLI)} on the card: losses {got} == the one-device "
        f"step's {want}")
    return losses


def cov_pod_data_syncs(dev, seed):
    """The gradient syncs over ``("pod", "data")`` on COV_SYNC_MESH: every
    method (and the int8 wire) on seeded float32 leaves of qwen3-1.7b's
    shapes, on the card against the same calls on the CPU (the sums within
    SYNC_REL_TOL of each leaf's largest, or the int8 wire's quantized
    values equal), every rank's bytes equal to ``grad_sync_bytes`` over the
    axes' sizes."""
    import torch

    from repro_torch.core import collectives
    from repro_torch.dist.sharding import SimMesh

    mesh = SimMesh(*COV_SYNC_MESH)
    axes, p = mesh.axis_names, mesh.ranks
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    leaves = [torch.randn((p,) + shape, generator=gen) for shape in COV_SYNC_LEAVES]
    out = {}
    for method, fanout in DIST_CASES:
        rec = {"bit_equal": True, "rel_err": 0.0}
        comms = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            comms[name] = collectives.Communicator(mesh, d)
        for g in leaves:
            res = {}
            for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
                x = g.to(d)
                if method == "int8":
                    y = collectives.sync_leaf_int8(x, comms[name], fanout=fanout, axes=axes)
                else:
                    y = collectives.sync_leaf(x, comms[name], method=method, fanout=fanout,
                                              axes=axes)
                res[name] = y.cpu()
            rec["bit_equal"] &= bool(torch.equal(res["card"], res["cpu"]))
            rec["rel_err"] = max(rec["rel_err"], rel_err(res["card"], res["cpu"]))
        want = sum(collectives.grad_sync_bytes("butterfly" if method == "int8" else method,
                                               mesh.sizes, fanout, g[0].numel(), 4,
                                               "int8" if method == "int8" else None)
                   for g in leaves)
        for name, c in comms.items():
            if not (c.bytes_sent == want).all():
                raise AssertionError(f"pod x data sync {method} fanout {fanout} on {name}: bytes "
                                     f"{c.bytes_sent} != the byte model {want}")
        bound = SYNC_REL_TOL if method != "int8" else 1.0 / 127
        if not rec["rel_err"] <= bound:
            raise AssertionError(f"pod x data sync {method} fanout {fanout}: the card is "
                                 f"{rec['rel_err']:.3g} from the CPU")
        rec["bytes_per_rank"] = want
        out[f"{method} fanout {fanout}"] = rec
    log(f"  gradient syncs over (pod, data) on {dict(zip(axes, mesh.sizes))}: every method on "
        f"the card == the CPU ({', '.join(k + (' bit-equal' if v['bit_equal'] else ' %.1e' % v['rel_err']) for k, v in out.items())}); "
        f"bytes a rank == grad_sync_bytes over the axes' sizes")
    return out


def cov_prefill_flops(dev, seed):
    """``FlopCounterMode``'s count of qwen3-1.7b's prefill (COV_PREFILL rows
    and tokens) on the card equal to the same call under fake tensors in
    this process (``launch.hlo_stats.measure``)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.launch import hlo_stats
    from repro_torch.models import api

    cfg = configs.get_config(LM_ARCH)
    b, p = COV_PREFILL
    fn = api.prefill_fn(cfg)
    model = api.init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    with torch.inference_mode():
        real = hlo_stats.measure(fn, model, {"tokens": toks})
    real.out = None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with FakeTensorMode(), torch.inference_mode():
        fake = hlo_stats.measure(fn, api.build_model(cfg, torch.device("cpu")),
                                 {"tokens": torch.zeros((b, p), dtype=toks.dtype)})
    fake.out = None
    if real.flops != fake.flops or real.flops_by_op != fake.flops_by_op or real.flops <= 0:
        raise AssertionError(f"prefill: the card counts {real.flops:.6g} flops "
                             f"({real.flops_by_op}), fake tensors {fake.flops:.6g} "
                             f"({fake.flops_by_op})")
    out = dict(batch=b, prompt=p, flops=real.flops, flops_by_op=real.flops_by_op,
               real_peak_bytes=real.memory["peak_bytes_per_device"],
               fake_peak_bytes=fake.memory["peak_bytes_per_device"])
    log(f"  {cfg.name} prefill of {b} x {p} in FlopCounterMode on the card == under fake "
        f"tensors: {real.flops:.6g} flops exactly "
        f"({', '.join(f'{k} {v:.6g}' for k, v in real.flops_by_op.items())}); peak card "
        f"{out['real_peak_bytes'] / 1e9:.3f} GB, fake {out['fake_peak_bytes'] / 1e9:.3f} GB")
    return out


def cov_other(dev, seed):
    """Group 4: serve_lm for every arch, launch.train's butterfly sync,
    GPipe on (stage 4, data 2), the (pod, data) gradient syncs, the
    prefill's flop count."""
    out = {"serve_lm": cov_serve_lm(dev), "train_cli": cov_train_cli(dev)}
    with exact_float32():
        out["gpipe"] = gpipe(dev, seed, data=2)
    gc.collect()
    __import__("torch").cuda.empty_cache()
    out["syncs"] = cov_pod_data_syncs(dev, seed)
    out["prefill_flops"] = cov_prefill_flops(dev, seed)
    return out


def run_lm_coverage(dev, seed, tmp, groups=LM_GROUPS, phase=log):
    """``--coverage lm``: ``groups`` of LM_GROUPS in order, each after
    ``phase``'s line; the graph kernels' counts read around the whole and
    held at 0 (none of the four is on these paths)."""
    import torch

    from repro_torch.kernels import build

    steps = {"loss": ("0, deepseek-7b's loss: the steps of 3g(b) unsharded, "
                      "tensor-parallel and with FSDP", lambda: cov_loss(dev, seed)),
             "fsdp": ("1, FSDP for qwen3-moe, gemma3, kimi-k2, jamba, internvl2 and whisper "
                      "beside tensor parallelism", lambda: cov_fsdp(dev, seed)),
             "state": ("2, FSDP state: restart, restore onto data 8, pod x data",
                       lambda: cov_state(dev, seed, tmp)),
             "families": ("3, the four families beyond serving: butterfly steps, restarts, "
                          "jamba's training, split kv heads, the gloo family group",
                          lambda: cov_families(dev, seed, tmp)),
             "other": ("4, serve_lm, launch.train's butterfly, GPipe on data 2, the (pod, "
                       "data) syncs, the prefill's flops", lambda: cov_other(dev, seed))}
    out = {}
    build.reset_launches()
    for name in groups:
        label, fn = steps[name]
        phase(f"[coverage lm, group {label}]")
        t0 = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        log(f"  group {name}: {out[name + '_s']:.1f} s")
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"the LM coverage launched graph kernels: {launched}")
    return out


# ---------------------------------------------------------------------------
# --coverage graph: the traversals over the mesh, their kernel sites, the
# per-group syncs and the serving and ops stack
# ---------------------------------------------------------------------------

# the one-axis run's syncs of each traversal over the mesh; the 32-lane wave
# and the 4-lane BC wave of phases 11 and 13
COV_WAVE_SYNCS = ("butterfly", "adaptive")
COV_PROGRAM_SYNCS = {"pagerank": ("butterfly", "sparse"), "kcore": ("butterfly", "adaptive"),
                     "tri": ("butterfly", "adaptive")}
COV_ENGINE_ROOTS = 40
COV_ENGINE_SSSP = 2
# the straddle inputs of tests/test_torch_axes_sync.py: active words a rank
# by pod, the capacity, the adaptive threshold, the words a rank
COV_STRADDLE = ((3, 40), 16, 0.02, 256)
COV_STRADDLE_MESH = ((2, 4), ("pod", "data"))
# the serving stack's runs: (a) one service, traced, metrics on a free port,
# a swap after COV_SWAP_AFTER requests, mutations recorded; (b) two replicas
# under the batch faults, a stall (on an op before the first mutation batch:
# a victim behind the read version is not stalled) past the router's
# timeout, and a kill
COV_SWAP_AFTER = 20
COV_CHAOS = ("kill-one@op=20;stall@op=2:ms=8000;drop-batch@batch=1;dup-batch@batch=2;"
             "corrupt-batch@batch=3;delay-batch@batch=4:ms=300")
# the router's timeout, past which the hedge fires (its hard timeout twice
# it): under the stall, above a scale-20 wave beside mutation batches and a
# replica's rebuild (at 0.5 s an H100 run failed 13 of 50 requests on the
# hard timeout, at 2 s 5, with requests of 3.2 s)
COV_ROUTER_TIMEOUT_S = 5.0
CONSOLE_ROUTES = ("/debug/requests", "/debug/replicas", "/debug/cache", "/debug/slo",
                  "/debug/events", "/dashboard", "/metrics", "/healthz")
# the keys of the reference console's JSON answers (repro.service.console)
CONSOLE_KEYS = {"/debug/requests": {"available", "inflight", "recent"},
                "/debug/replicas": {"available", "head_seq", "replicas", "n_serving"},
                "/debug/cache": {"available"},
                "/debug/slo": {"available", "objectives", "alerts"},
                "/debug/events": {"count", "trace_id", "events"},
                "/healthz": {"status", "replicas"}}


class KernelCensus:
    """Every kernel wrapper's calls inside the block, by path: the launch
    count of each (name, shapes) site and a copy of its first call's
    arguments (``sites``), for holding each site against its plain version
    after the paths have run. ``path`` names the calls that follow."""

    def __init__(self):
        self.path = None
        self.sites = {}
        self._saved = []

    def __enter__(self):
        from repro_torch.kernels import bitmap_merge, ops

        targets = [(bitmap_merge, "bitmap_or_reduce")]
        targets += [(ops, n) for n in ("frontier_gather_full", "frontier_gather",
                                       "frontier_scatter")]
        for mod, name in targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            if self.path is not None:
                shapes = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
                key = (name, self.path, shapes, tuple(sorted(
                    (k, v) for k, v in kwargs.items() if isinstance(v, (int, bool)))))
                site = self.sites.get(key)
                if site is None:
                    site = self.sites[key] = dict(
                        launches=0, args=tuple(a.clone() if hasattr(a, "clone") else a
                                               for a in args), kwargs=dict(kwargs))
                site["launches"] += 1
            return fn(*args, **kwargs)
        return call

    def cases(self):
        """One ``check_kernel`` case a site: its first call's arguments,
        the least bytes it must move."""
        import torch

        out = []
        for (name, path, shapes, _), site in self.sites.items():
            args, kwargs = site["args"], dict(site["kwargs"])
            case = dict(name=name, cell="kronecker", path=path,
                        plane="mesh " + " ".join(str(s) for s in shapes), args=args,
                        kwargs=kwargs, launches=site["launches"])
            if name == "bitmap_or_reduce":
                k = args[0].shape[1]
                case["bytes"] = nbytes(args[0]) // k * (k + 1)
            elif name == "frontier_gather_full":
                words, src = args[:2]
                case["ids_sorted"] = kwargs.pop("ids_sorted", False)
                case["bytes"] = distinct_word_bytes(src >> 5) + nbytes(src) + src.numel()
            elif name == "frontier_gather":
                words, ws, src = args[:3]
                ww = kwargs["ww"]
                window = (ws.long() * ww)[..., None] + torch.arange(ww, device=ws.device)
                case["bytes"] = distinct_word_bytes(window) + nbytes(ws, src) + src.numel()
            else:
                active, win, dst = args[:3]
                case["bytes"] = scatter_least_bytes(active, win, dst, active.shape[0]
                                                    * kwargs["n_windows"] * kwargs["ww"])
            out.append(case)
        return out


def axes_pair(label, census, one, hier, compare, must_merge=False):
    """``one()`` and ``hier()`` (the one-axis and the mesh run of one path)
    each once with the launch counts set to 0 just before, the mesh run's
    kernel calls under ``census`` as ``label``: ``compare(one_out,
    mesh_out)`` must hold, the launches equal, and where ``must_merge``
    ``bitmap_or_reduce`` launched. Returns ``(mesh out, summary)``."""
    o1, ms1, l1, _ = timed_run(one)
    census.path = label
    try:
        om, msm, lm, peak = timed_run(hier)
    finally:
        census.path = None
    compare(o1, om)
    if lm != l1:
        raise AssertionError(f"{label}: launches {lm} != the one-axis run's {l1}")
    if must_merge and not lm.get("bitmap_or_reduce"):
        raise AssertionError(f"{label}: bitmap_or_reduce never launched ({lm})")
    return om, dict(ms=msm, one_axis_ms=ms1, launches=lm, peak_bytes=peak)


def cov_traversals(kron, small, fanout, seed, dev, census):
    """Group 6: each traversal over the (pod, data) mesh against the
    one-axis P-rank run of the same roots and sync: the 32-lane MS-BFS wave
    under butterfly and adaptive, a 4-lane BC wave, PageRank (within
    PR_SLACK), k-core and triangles at their small scales, the query
    engine's BFS, SSSP and CC batch, and a streaming repair under the
    butterfly on a deep copy of the partition. Each traced run's bytes a
    rank equal the byte model over the axes' sizes at every level; the
    paths that must merge launch ``bitmap_or_reduce``. Returns the paths'
    summaries and a function a path to run it once more (the profiles)."""
    import numpy as np
    import torch

    from repro_torch import programs
    from repro_torch.analytics import msbfs
    from repro_torch.analytics.engine import BFSQueryEngine
    from repro_torch.core import bfs, collectives, flightrec
    from repro_torch.graph import csr
    from repro_torch.traversal import bc, sssp

    g, pg, arrays = kron["g"], kron["pg"], kron["arrays"]
    mesh = axes_mesh(pg.p)
    axes, sizes = mesh.axis_names, mesh.sizes
    paths, reruns = {}, {}

    def equal_outputs(label):
        def compare(a, b):
            a, b = a[:3], b[:3]
            if not (torch.equal(a[0], b[0]) and tuple(a[1:]) == tuple(b[1:])):
                raise AssertionError(f"{label}: differs from the one-axis run "
                                     f"({tuple(b[1:])} / {tuple(a[1:])})")
        return compare

    # the multi-source wave
    roots = csr.largest_component_roots(g, LANES, np.random.default_rng(seed + 1),
                                        labels=kron["labels"])
    for sync in COV_WAVE_SYNCS:
        label = f"axes wave {sync}"
        one_cfg = bfs.BFSConfig(fanout=fanout, sync=sync, mode="direction_optimizing")
        cfg = dataclasses.replace(one_cfg, axes=axes)
        one = msbfs.build_msbfs_fn(pg, one_cfg, LANES, device=dev)
        hier = msbfs.build_msbfs_fn(pg, cfg, LANES, device=dev, mesh=mesh)
        hier(arrays, roots)
        out, summ = axes_pair(label, census, lambda: one(arrays, roots),
                              lambda: hier(arrays, roots), equal_outputs(label),
                              must_merge=sync == "butterfly")
        n_words = msbfs.wave_rows(pg) * msbfs.lane_words(LANES)
        ct = collectives.Communicator(mesh, dev)
        per_level = LevelBytes(ct)
        traced = msbfs.build_msbfs_fn(pg, cfg, LANES, device=dev, trace=True,
                                      trace_levels=out[1], mesh=mesh)
        tout = traced(arrays, roots, ct, level_ms=per_level)
        if not torch.equal(tout[0], out[0]):
            raise AssertionError(f"{label}: the traced wave differs")
        trace = flightrec.TraversalTrace.from_buffer(
            tout[3], algo="msbfs", sync=sync, p=pg.p, fanout=fanout, n_words=n_words,
            capacity=cfg.resolved_capacity(n_words), density_threshold=cfg.density_threshold,
            axis_sizes=sizes)
        summ.update(levels=out[1], scanned=float(out[2]), lanes=LANES,
                    bytes_per_rank=level_bytes_check(label, trace, per_level, pg.p, out[1]))
        paths[label] = summ
        reruns[label] = lambda fn=hier: fn(arrays, roots)
        log(f"  {label}: {LANES} lanes == one-axis P={pg.p} ({out[1]} levels, "
            f"{float(out[2]):.0f} edges); launches {summ['launches']}; bytes a rank "
            f"{summ['bytes_per_rank']:,} == the model at every level; {summ['ms']:.3f} ms "
            f"(one axis {summ['one_axis_ms']:.3f})")
        del out, tout
        torch.cuda.empty_cache()

    # the BC wave: lane levels exact, the dependency sums within BC's 1e-4
    label = "axes bc butterfly"
    bc_roots = csr.largest_component_roots(g, BC_LANES, np.random.default_rng(seed + 3),
                                           labels=kron["labels"]).tolist()
    one_cfg = bfs.BFSConfig(fanout=fanout, sync="butterfly", mode="top_down")
    cfg = dataclasses.replace(one_cfg, axes=axes)
    one = bc.build_bc_fn(pg, one_cfg, BC_LANES, device=dev)
    hier = bc.build_bc_fn(pg, cfg, BC_LANES, device=dev, mesh=mesh)
    lanes1, lanesm = {}, {}

    def bc_compare(a, b):
        if not (torch.equal(lanes1["levels"], lanesm["levels"]) and a[1:] == b[1:]):
            raise AssertionError(f"{label}: lane levels or depth differ from the one-axis run")
        if not torch.allclose(b[0], a[0], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{label}: dependency sums differ from the one-axis run by "
                                 f"{float((b[0] - a[0]).abs().max())}")

    hier(arrays, bc_roots)
    out, summ = axes_pair(label, census, lambda: one(arrays, bc_roots, lanes=lanes1),
                          lambda: hier(arrays, bc_roots, lanes=lanesm), bc_compare,
                          must_merge=True)
    n_flat = msbfs.wave_rows(pg) * msbfs.lane_words(BC_LANES)
    or_comm = collectives.Communicator(mesh, dev)
    per_level = LevelBytes(or_comm)
    traced = bc.build_bc_fn(pg, cfg, BC_LANES, device=dev, trace=True, trace_levels=out[1],
                            mesh=mesh)
    tout = traced(arrays, bc_roots, or_comm=or_comm, level_ms=per_level)
    trace = flightrec.TraversalTrace.from_buffer(
        tout[-1], algo="bc", sync="butterfly", p=pg.p, fanout=fanout, n_words=n_flat,
        capacity=cfg.resolved_capacity(n_flat), axis_sizes=sizes)
    summ.update(depth=out[1], scanned=float(out[2]), lanes=BC_LANES,
                max_abs_diff=float((out[0] - one(arrays, bc_roots)[0]).abs().max()),
                forward_bytes_per_rank=level_bytes_check(label, trace, per_level, pg.p,
                                                         out[1]))
    paths[label], reruns[label] = summ, lambda fn=hier: fn(arrays, bc_roots)
    log(f"  {label}: {BC_LANES} lanes' levels == one-axis, dependency sums within rtol "
        f"and atol 1e-4 (max abs diff {summ['max_abs_diff']:.3g}); {out[1]} levels; launches {summ['launches']}; "
        f"forward OR bytes a rank {summ['forward_bytes_per_rank']:,} == the model at every "
        f"level; {summ['ms']:.3f} ms (one axis {summ['one_axis_ms']:.3f})")
    del out, tout, lanes1, lanesm
    torch.cuda.empty_cache()

    # the vertex programs: PageRank on the Kronecker graph (deterministic
    # algorithms: its scatter_add), k-core and triangles at their scales
    for algo, syncs in COV_PROGRAM_SYNCS.items():
        parts = kron if algo == "pagerank" else small[algo]
        prog = programs.by_name(algo)
        for sync in syncs:
            label = f"axes {algo} {sync}"
            one_cfg = programs.ProgramConfig(fanout=fanout, sync=sync)
            cfg = dataclasses.replace(one_cfg, axes=axes)
            ppg, parr = parts["pg"], parts["arrays"]
            one = programs.build_program_fn(ppg, prog, one_cfg, device=dev)
            hier = programs.build_program_fn(ppg, prog, cfg, device=dev, mesh=mesh)
            arg = prog.default_arg(ppg, dev)

            def compare(a, b, label=label, algo=algo):
                if algo == "pagerank":
                    diff = float((a[0] - b[0]).abs().max())
                    ok = diff <= PR_SLACK
                else:
                    ok = all(torch.equal(x, y) for x, y in zip(a[:-2], b[:-2]))
                if not ok or a[-2:] != b[-2:]:
                    raise AssertionError(f"{label}: differs from the one-axis run "
                                         f"(rounds {b[-2]} / {a[-2]})")

            ctx = deterministic() if algo == "pagerank" else contextlib.nullcontext()
            with ctx:
                out, summ = axes_pair(label, census, lambda: one(parr, arg),
                                      lambda: hier(parr, arg), compare,
                                      must_merge=algo != "pagerank" and sync == "butterfly")
                n_words = programs.program_msg_words(ppg, prog)
                ct = collectives.Communicator(mesh, dev)
                per_level = LevelBytes(ct)
                traced = programs.build_program_fn(ppg, prog, cfg, device=dev, trace=True,
                                                   trace_levels=out[-2], mesh=mesh)
                tout = traced(parr, arg, ct, level_ms=per_level)
            trace = flightrec.TraversalTrace.from_buffer(
                tout[-1], algo=algo, sync=sync, p=ppg.p, fanout=fanout, n_words=n_words,
                capacity=cfg.resolved_capacity(n_words),
                density_threshold=cfg.density_threshold, axis_sizes=sizes)
            summ.update(rounds=out[-2], work=float(out[-1]), scale=parts["scale"],
                        bytes_per_rank=level_bytes_check(label, trace, per_level, ppg.p,
                                                         out[-2]))
            if algo == "pagerank":
                summ["max_abs_diff"] = float((out[0] - timed_run(one, parr, arg)[0][0])
                                             .abs().max())
            paths[label] = summ
            reruns[label] = lambda fn=hier, a=parr, x=arg: fn(a, x)
            log(f"  {label} (scale {summ['scale']}): == one-axis "
                f"{'within PR_SLACK' if algo == 'pagerank' else 'bit for bit'}, {out[-2]} "
                f"rounds; launches {summ['launches']}; bytes a rank {summ['bytes_per_rank']:,} "
                f"== the model at every round; {summ['ms']:.3f} ms (one axis "
                f"{summ['one_axis_ms']:.3f})")
            del out, tout
            torch.cuda.empty_cache()

    # the query engine: a batch of BFS, SSSP and CC queries
    label = "axes engine"
    eroots = csr.largest_component_roots(g, COV_ENGINE_ROOTS, np.random.default_rng(seed + 7),
                                         labels=kron["labels"]).tolist()
    ecfg = bfs.BFSConfig(fanout=fanout, sync="butterfly")
    engines = {}

    def batch(eng):
        return (eng.query(eroots), eng.sssp(eroots[:COV_ENGINE_SSSP]),
                eng.vertex_program("cc"))

    def engine_compare(a, b):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{label}: answers differ from the one-axis engine's")
        if engines["one"].stats != engines["mesh"].stats:
            raise AssertionError(f"{label}: stats {engines['mesh'].stats} != "
                                 f"{engines['one'].stats}")

    engines["one"] = BFSQueryEngine(pg, ecfg, lanes=LANES, device=dev)
    engines["mesh"] = BFSQueryEngine(pg, dataclasses.replace(ecfg, axes=axes), lanes=LANES,
                                     device=dev, mesh=mesh)
    _, summ = axes_pair(label, census, lambda: batch(engines["one"]),
                        lambda: batch(engines["mesh"]), engine_compare, must_merge=True)
    summ.update(bfs=len(eroots), sssp=COV_ENGINE_SSSP, cc=1,
                waves=engines["mesh"].stats.waves)
    paths[label] = summ
    log(f"  {label}: {len(eroots)} BFS, {COV_ENGINE_SSSP} SSSP and one CC query == the "
        f"one-axis engine's, stats equal ({summ['waves']} waves); launches "
        f"{summ['launches']}; {summ['ms']:.1f} ms (one axis {summ['one_axis_ms']:.1f})")
    del engines
    torch.cuda.empty_cache()

    paths.update(cov_repair(kron, fanout, seed, dev, census, mesh))
    return paths, reruns


def cov_repair(kron, fanout, seed, dev, census, mesh):
    """A streaming repair over the mesh: a seeded mixed batch cut to the
    slack, patched in place on a deep copy of the partition
    (:func:`mutation_setup`), each cached BFS and SSSP row repaired under
    the butterfly over ``("pod", "data")`` equal bit for bit to the
    one-axis repair and to the from-scratch traversal of the mutated copy,
    the bytes a rank equal to the one-axis run's, a tainted repair
    launching ``bitmap_or_reduce``."""
    import numpy as np

    from repro_torch.core import collectives
    from repro_torch.dynamic import delta, repair
    from repro_torch.traversal import sssp

    mut = mutation_setup(kron, fanout, seed, dev, REPAIR_ROOTS)
    pg, eng = mut["pg"], mut["engine"]
    batch, kept = fitting_batch(mut["overlay"], pg, mut["rng"], MUTATION_INSERTS,
                                MUTATION_DELETES, WEIGHT)
    update = mut["overlay"].apply(batch)
    if not delta.apply_update_to_partition(pg, update):
        raise AssertionError("axes repair: the in-place patch refused a batch cut to the slack")
    eng.refresh_arrays()
    out = {}
    for r in mut["roots"]:
        for kind in ("bfs", "sssp"):
            label = f"axes repair {kind} {r}"
            want = mut["scratch"][kind](eng._arrays, r)
            row = mut["rows"][kind, r]
            comms = {}

            def run(on, cfg):
                comms[on] = collectives.Communicator(mesh if on == "mesh" else pg.p, dev)
                return repair.repair_row(pg, row, update, cfg, unit_weight=kind == "bfs",
                                         arrays=eng._arrays, device=dev, comm=comms[on],
                                         mesh=mesh if on == "mesh" else None)

            def compare(a, b, kind=kind, r=r):
                if not (np.array_equal(a[0], b[0]) and np.array_equal(b[0], want)
                        and a[1:] == b[1:]):
                    raise AssertionError(f"axes repair: {kind} root {r} differs from the "
                                         f"one-axis repair or from scratch")
                if not np.array_equal(comms["mesh"].bytes_sent, comms["one"].bytes_sent):
                    raise AssertionError(f"axes repair: {kind} root {r}: bytes "
                                         f"{comms['mesh'].bytes_sent} != one-axis "
                                         f"{comms['one'].bytes_sent}")

            tainted = repair.repair_seeds(row, update, unit_weight=kind == "bfs")[1].size > 0
            res, summ = axes_pair(label, census,
                                  lambda: run("one", sssp.SSSPConfig(fanout=fanout)),
                                  lambda: run("mesh", sssp.SSSPConfig(fanout=fanout,
                                                                      axes=mesh.axis_names)),
                                  compare, must_merge=tainted)
            summ.update(root=r, iters=res[2], touched=res[1], tainted=tainted,
                        bytes_per_rank=int(comms["mesh"].bytes_sent[0]))
            out[label] = summ
            log(f"  {label}: == one-axis and from scratch; {res[2]} iterations, "
                f"{res[1]:,} touched, tainted {tainted}; launches {summ['launches']}; "
                f"{summ['bytes_per_rank']:,} B a rank (== one axis); {summ['ms']:.1f} ms "
                f"(one axis {summ['one_axis_ms']:.1f})")
    log(f"  axes repair: {kept} inserts and {MUTATION_DELETES} deletes patched in place")
    return out


def cov_sites(census, paths):
    """Group 7: every (kernel, shapes) site the mesh paths called, on its
    first call's arguments, held exactly against the plain version and
    timed (``check_kernel``), with its launches in its path's run."""
    rows = []
    for case in census.cases():
        launches = case.pop("launches")
        rec = check_kernel(case)
        rec["launches"] = launches
        rows.append(rec)
        del case["args"]
    census.sites.clear()
    return rows


def straddle_words(case_counts, n_words, seed, mesh, base=None):
    """uint32 words as int32 ``[P, n_words]``: each rank ``case_counts[pod]``
    active words (nonzero, or lowered below ``base``), as
    ``tests/test_torch_axes_sync.py``'s ``_words``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    p, per_pod = mesh.ranks, mesh.ranks // mesh.sizes[0]
    x = np.zeros((p, n_words), np.uint32) if base is None else np.tile(base, (p, 1))
    for r in range(p):
        n = case_counts[r // per_pod % len(case_counts)]
        ii = rng.choice(n_words, size=n, replace=False)
        if base is None:
            x[r, ii] = rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        else:
            x[r, ii] = (base[ii] * rng.random(n)).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def cov_straddle(dev, census):
    """Group 8: the per-group branches. The straddle inputs (one pod's
    ranks under the capacity, the other's over it) through
    ``butterfly_or_sparse``/``_adaptive`` and ``butterfly_reduce_sparse``/
    ``_adaptive`` (MIN against a shared reference, ADD in delta mode) over
    ``axes=("data",)`` on COV_STRADDLE_MESH at fanouts 2 and 4, on the card
    against the same calls on CPU tensors: every rank's words and bytes
    equal, the pods' bytes apart (they took different branches)."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as coll, monoid as mono
    from repro_torch.dist.sharding import SimMesh

    counts, cap, thr, nw = COV_STRADDLE
    mesh = SimMesh(*COV_STRADDLE_MESH)
    axes = ("data",)
    out = {}
    cpu = torch.device("cpu")
    for fanout in (2, 4):
        for kind in ("sparse", "adaptive"):
            extra = {} if kind == "sparse" else dict(density_threshold=thr)
            rng = np.random.default_rng(fanout)
            ref = rng.integers(1 << 20, 2**32, size=nw, dtype=np.uint64).astype(np.uint32)
            ref_t = torch.from_numpy(ref.view(np.int32))
            cases = {
                "or": (straddle_words(counts, nw, fanout * 10 + 1, mesh),
                       lambda x, c, d: getattr(coll, f"butterfly_or_{kind}")(
                           x, c, fanout=fanout, capacity=cap, axes=axes, **extra)),
                "min": (straddle_words(counts, nw, fanout, mesh, base=ref),
                        lambda x, c, d: getattr(coll, f"butterfly_reduce_{kind}")(
                            x, c, mono.MIN_U32, fanout=fanout, capacity=cap, axes=axes,
                            ref=ref_t.to(d), **extra)),
                "add": (straddle_words(counts, nw, fanout + 1, mesh),
                        lambda x, c, d: getattr(coll, f"butterfly_reduce_{kind}")(
                            x, c, mono.ADD_U32, fanout=fanout, capacity=cap, axes=axes,
                            **extra)),
            }
            for op, (x, fn) in cases.items():
                label = f"straddle {op} {kind} fanout {fanout}"
                got = {}
                for d in (dev, cpu):
                    comm = coll.Communicator(mesh, d)
                    census.path = label if d == dev else None
                    try:
                        got[d.type] = (fn(x.to(d), comm, d).cpu(), comm.bytes_sent.copy())
                    finally:
                        census.path = None
                (a, ba), (b, bb) = got[dev.type], got["cpu"]
                if not (torch.equal(a, b) and np.array_equal(ba, bb)):
                    raise AssertionError(f"{label}: the card's words or bytes differ from the "
                                         f"CPU's ({ba} / {bb})")
                if len(set(ba.tolist())) < 2:
                    raise AssertionError(f"{label}: every group took one branch ({ba})")
                out[label] = dict(bytes_per_rank=ba.tolist())
    log(f"  the per-group branches over (data,) on {dict(zip(mesh.axis_names, mesh.sizes))}, "
        f"pods of {counts} active words against capacity {cap}: {len(out)} syncs on the card == "
        f"the CPU bit for bit, the pods' bytes apart (e.g. "
        f"{next(iter(out.values()))['bytes_per_rank']})")
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fetch_console(port, want_replicas, deadline_s=120.0):
    """Each of CONSOLE_ROUTES over HTTP on localhost, once the run serves
    them: ``{route: (status, body)}``, JSON routes decoded. Returns None if
    the server never answered before ``deadline_s``."""
    import json as _json
    import urllib.error
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                health = _json.loads(r.read())
            if len(health.get("replicas", [])) == want_replicas:
                break
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.1)
    else:
        return None
    out = {}
    for route in CONSOLE_ROUTES:
        try:
            with urllib.request.urlopen(base + route, timeout=30) as r:
                status, body, ctype = r.status, r.read().decode(), r.headers.get(
                    "Content-Type", "")
        except urllib.error.HTTPError as exc:  # /healthz: 503 once no replica serves
            status, body, ctype = exc.code, exc.read().decode(), exc.headers.get(
                "Content-Type", "")
        out[route] = (status, _json.loads(body) if "json" in ctype else body)
    return out


def run_cli_with_console(argv, port, replicas):
    """``serve_graph.main(argv)`` in a thread of this process while its
    console's routes are fetched over HTTP: ``(exit code, routes)``."""
    from repro_torch.launch import serve_graph

    box = {}

    def target():
        try:
            box["rc"] = serve_graph.main(argv)
        except BaseException as exc:  # noqa: BLE001  (re-raised by the caller)
            box["exc"] = exc

    th = threading.Thread(target=target, daemon=True)
    th.start()
    routes = fetch_console(port, replicas)
    th.join()
    if "exc" in box:
        raise box["exc"]
    return box["rc"], routes


def check_console(label, routes, replicas):
    """The console's answers: every route 200 (``/healthz`` 503 where no
    replica serves), each JSON route's keys those of the reference's
    console (CONSOLE_KEYS), the replica table's rows, the dashboard's HTML
    and the Prometheus text."""
    if routes is None:
        raise AssertionError(f"{label}: the console never answered")
    bad = {r: s for r, (s, _) in routes.items()
           if s != 200 and not (r == "/healthz" and s == 503)}
    if bad:
        raise AssertionError(f"{label}: console routes answered {bad}")
    for route, keys in CONSOLE_KEYS.items():
        body = routes[route][1]
        if not isinstance(body, dict) or not keys <= set(body):
            raise AssertionError(f"{label}: {route} answered keys "
                                 f"{sorted(body) if isinstance(body, dict) else type(body)}, "
                                 f"the reference's console has {sorted(keys)}")
    rows = routes["/debug/replicas"][1]["replicas"]
    if len(rows) != replicas:
        raise AssertionError(f"{label}: /debug/replicas has {len(rows)} rows, {replicas} "
                             f"replicas run")
    if "<html" not in routes["/dashboard"][1].lower() or "# TYPE" not in routes["/metrics"][1]:
        raise AssertionError(f"{label}: the dashboard or the metrics text is malformed")
    return {r: (sorted(b) if isinstance(b, dict) else len(b)) for r, (_, b) in routes.items()}


def cov_serving(args, dev, kron, fanout, seed, out_dir):
    """Group 9: the serving and ops stack at ``args.cli_scale``. (a) one
    ``serve_graph.main`` traced, with metrics on a free port, a graph swap,
    mutations recorded; (b) two replicas under COV_CHAOS's batch faults and
    a stall on the killed replica's op, the router's timeout short; each
    run's console routes and metrics fetched over HTTP while it serves,
    its stats' keys the reference's, every event valid. Then the recorded
    updates replayed by ``launch.bfs_run --updates``; ``fault_exemplar``
    over (b)'s events (:func:`replayed_exemplar`); BC served by the service
    on a copy of phase 7's partition against phase 13's wave."""
    import json as _json

    import numpy as np
    import torch

    from repro_torch.core import events
    from repro_torch.launch import bfs_run

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ROOT, "tests", "event_schema.json")) as f:
        schema = _json.load(f)
    base = ["--scale", str(args.cli_scale), "--edge-factor", str(args.edge_factor),
            "--ranks", str(args.ranks), "--fanout", str(fanout), "--device", dev.type,
            "--seed", str(seed), "--qps", str(CLI_QPS), "--duration", str(args.cli_seconds),
            "--mutate-rate", str(CLI_MUTATE_RATE), "--mutate-edges", str(CLI_MUTATE_EDGES),
            "--slo-config", os.path.join(ROOT, "examples", "slo_chaos.json")]
    out = {}
    runs = {
        "a": ["--swap-after", str(COV_SWAP_AFTER), "--trace", "trace.json",
              "--record-updates", "updates.jsonl"],
        "b": ["--replicas", "2", "--chaos", COV_CHAOS, "--chaos-seed", str(CLI_CHAOS_SEED),
              "--router-timeout-s", str(COV_ROUTER_TIMEOUT_S), "--trace", "trace.json"],
    }
    for name, extra in runs.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        extra = [os.path.join(d, x) if x.endswith((".json", ".jsonl")) else x for x in extra]
        port = free_port()
        argv = base + extra + ["--metrics-port", str(port),
                               "--events", os.path.join(d, "events.jsonl"),
                               "--slo-verdict", os.path.join(d, "verdict.json"),
                               "--stats-json", os.path.join(d, "stats.json")]
        replicas = 2 if name == "b" else 1
        log(f"  serve_graph {' '.join(argv)}")
        t0 = time.perf_counter()
        rc, routes = run_cli_with_console(argv, port, replicas)
        wall_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve_graph ({name}): exit {rc}")
        keys = check_console(f"serve_graph ({name})", routes, replicas)
        with open(os.path.join(d, "stats.json")) as f:
            doc = _json.load(f)
        tele = doc["telemetry"]
        fb = tele["faults"]
        if set(doc) != STATS_KEYS | ({"trace"} if "trace" in doc else set()) \
                or set(fb) != FAULT_KEYS:
            raise AssertionError(f"serve_graph ({name}): stats keys {sorted(doc)}, faults "
                                 f"{sorted(fb)}")
        errs = events.validate_events_file(os.path.join(d, "events.jsonl"), schema)
        with open(os.path.join(d, "events.jsonl")) as f:
            evs = [_json.loads(line) for line in f if line.strip()]
        if errs or not evs:
            raise AssertionError(f"serve_graph ({name}): {len(evs)} events, violations "
                                 f"{errs[:5]}")
        if tele["failed"] or tele["completed"] != tele["submitted"]:
            raise AssertionError(f"serve_graph ({name}): {tele['failed']} failed of "
                                 f"{tele['submitted']}, {tele['completed']} completed")
        rec = dict(wall_s=wall_s, submitted=tele["submitted"], completed=tele["completed"],
                   failed=tele["failed"], p50_ms=tele["latency_ms"]["p50"],
                   p99_ms=tele["latency_ms"]["p99"], faults=fb, events=len(evs),
                   console=keys)
        if name == "a":
            for f_name in ("trace.json", "updates.jsonl"):
                if not os.path.getsize(os.path.join(d, f_name)):
                    raise AssertionError(f"serve_graph (a): {f_name} is empty")
            with open(os.path.join(d, "trace.json")) as f:
                rec["trace_events"] = len(_json.load(f)["traceEvents"])
        else:
            want = {"kill-replica", "stall-wave", "drop-batch", "dup-batch", "corrupt-batch",
                    "delay-batch"}
            missing = {k for k in want if not fb["injected"].get(k)}
            if missing or not fb["hedges"] or not fb["recoveries"]:
                raise AssertionError(f"serve_graph (b): faults {fb} (not injected: {missing})")
            rec["exemplar"] = replayed_exemplar(evs)

        out[name] = rec
        log(f"  serve_graph ({name}): {tele['completed']}/{tele['submitted']} completed, "
            f"{tele['failed']} failed; p50 {rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms; "
            f"faults {json.dumps({k: v for k, v in fb.items() if v})}; {len(evs)} events "
            f"valid; console {len(routes)} routes 200 over HTTP; {wall_s:.1f} s")
    lines = cli_lines(bfs_run.main, [
        "--scale", str(args.cli_scale), "--edge-factor", str(args.edge_factor), "--ranks",
        str(args.ranks), "--fanout", str(fanout), "--seed", str(seed), "--roots", "2",
        "--device", dev.type, "--updates", os.path.join(out_dir, "a", "updates.jsonl")])
    replay = [ln for ln in lines if ln.startswith("replayed updates")]
    if not replay:
        raise AssertionError(f"bfs_run --updates: no replay line in {lines[-5:]}")
    out["replay"] = replay[0]
    log(f"  bfs_run --updates on the card: {replay[0]}")
    out["bc"] = cov_service_bc(kron, fanout, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def replayed_exemplar(evs):
    """``serve_graph.fault_exemplar`` over run (b)'s event log (its events
    emitted again into a log of their own): the pick is the trace of the
    newest event an injection stamped (``kill-replica`` or
    ``stall-wave``), the stalled request's trace holds the hedge, and the
    log held a stall."""
    from repro_torch.core.events import EventLog
    from repro_torch.launch import serve_graph

    log_ = EventLog(capacity=len(evs) + 1)
    for e in evs:
        log_.emit(e["kind"], e["name"], subsystem=e.get("subsystem", ""),
                  trace_id=e.get("trace_id", ""), args=e.get("args"))
    pick = serve_graph.fault_exemplar(log_)()
    stamped = [e for e in evs if e["kind"] == "chaos" and e["trace_id"]
               and e["name"] in ("kill-replica", "stall-wave")]
    stalls = [e["trace_id"] for e in stamped if e["name"] == "stall-wave"]
    hedged = {e["trace_id"] for e in evs if e["kind"] == "retry" and e["name"] == "hedge"}
    if not stalls or pick is None or pick["trace_id"] != stamped[-1]["trace_id"]:
        raise AssertionError(f"fault_exemplar: {pick} under stalls {stalls}, the newest "
                             f"injection {stamped[-1:]}")
    if not set(stalls) & hedged:
        raise AssertionError(f"fault_exemplar: no stalled request was hedged ({stalls}, "
                             f"hedged {sorted(hedged)})")
    log(f"  fault_exemplar over run (b)'s {len(evs)} events: {pick['source']} "
        f"{pick['trace_id']} (the newest injection's trace); the stalled request "
        f"{stalls[0]} holds its hedge")
    return pick


def cov_service_bc(kron, fanout, seed, dev):
    """``bc`` requests for phase 13's BC_LANES roots through
    ``GraphQueryService`` (one lane a wave) on a deep copy of the Kronecker
    partition: the answers' sum within BC's 1e-4 of phase 13's wave on the
    same roots."""
    import copy

    import numpy as np

    from repro_torch.core import bfs
    from repro_torch.graph import csr
    from repro_torch.service import GraphQueryService
    from repro_torch.traversal import bc

    g, pg = kron["g"], kron["pg"]
    roots = csr.largest_component_roots(g, BC_LANES, np.random.default_rng(seed + 3),
                                        labels=kron["labels"]).tolist()
    cfg = bfs.BFSConfig(fanout=fanout, sync="butterfly", mode="top_down")
    wave = bc.build_bc_fn(pg, cfg, BC_LANES, device=dev)(kron["arrays"], roots)
    want = bc.assemble_bc(pg, wave[0].cpu())
    del wave
    # one lane a wave: a 4-lane wave at scale 23 peaks at 60.5 GB, beside the
    # service's own placement of the copy
    svc = GraphQueryService(copy.deepcopy(pg), dev, cfg, lanes=1, n_real=g.n_real)
    try:
        t0 = time.perf_counter()
        got = sum(np.asarray(f.result(timeout=600), np.float64)
                  for f in [svc.submit("bc", r) for r in roots])
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        svc.stop()
    if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"service bc: differs from phase 13's wave by "
                             f"{np.abs(got - want).max()}")
    log(f"  service bc: {len(roots)} requests' sum == phase 13's {BC_LANES}-lane wave within "
        f"rtol and atol 1e-4 (max abs diff {np.abs(got - want).max():.3g}); {ms:.1f} ms")
    return dict(roots=roots, ms=ms, max_abs_diff=float(np.abs(got - want).max()))


def run_graph_coverage(args, dev, phase, out_dir):
    """``--coverage graph``: phase 2's build, phase 7's Kronecker partition
    on (pod, data), then groups 6-9 in order; a profile of each mesh path
    for its merges' in-run ms."""
    import torch

    from repro_torch.graph import generators
    from repro_torch.kernels import build

    phase("[coverage graph] build and ETL")
    if dev.type == "cuda":  # a rehearsal on the CPU takes the plain routes
        t0 = time.perf_counter()
        lib = build.build()
        build.library()
        log(f"  built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    kron = etl(f"kronecker scale {args.scale} EF {args.edge_factor}, weights 1..{WEIGHT}",
               lambda: generators.kronecker(args.scale, args.edge_factor, seed=args.seed,
                                            max_weight=WEIGHT),
               args.ranks, dev, "direction_optimizing")
    kron["scale"] = args.scale
    small = {}
    for what, scale in (("kcore", args.kcore_scale), ("tri", args.tri_scale)):
        small[what] = etl(f"kronecker scale {scale} EF {args.edge_factor} ({what})",
                          lambda scale=scale: generators.kronecker(
                              scale, args.edge_factor, seed=args.seed),
                          args.ranks, dev, "top_down")
        small[what]["scale"] = scale
    out = {}
    with KernelCensus() as census:
        phase(f"[coverage graph, group 6] traversals over pod {args.ranks // AXES_POD_SIZE} x "
              f"data {AXES_POD_SIZE} against the one-axis P={args.ranks} runs")
        out["paths"], reruns = cov_traversals(kron, small, args.fanout, args.seed, dev, census)
        phase("[coverage graph, group 8] the per-group branches (straddle inputs)")
        out["straddle"] = cov_straddle(dev, census)
    phase("[coverage graph, group 7] every kernel site of groups 6 and 8, exact and timed")
    out["sites"] = cov_sites(census, out["paths"])
    for label, run in reruns.items():
        torch.cuda.empty_cache()
        out["paths"][label]["profile"] = merge_profile(label, run)
    site_rows = cov_site_table(out["sites"], out["paths"])
    del reruns
    torch.cuda.empty_cache()
    phase(f"[coverage graph, group 9] the serving and ops stack at scale {args.cli_scale}")
    out["serving"] = cov_serving(args, dev, kron, args.fanout, args.seed,
                                 os.path.join(args.cli_out, "coverage"))
    return out, site_rows


def cov_site_table(rows, paths):
    """Each site's launches in its path's run, isolated ms, in-run ms a
    launch (its path's profile, where the path has one and the profiler
    saw every launch: the mean over the path's merges), bound and gap a
    run; logged."""
    log("  site (path): launches a run | isolated ms | in-run ms a launch | bound ms (MB) | "
        "gap ms a run")
    for rec in rows:
        prof = paths.get(rec["path"], {}).get("profile") or {}
        per = prof.get("ms_per_launch") if rec["name"] == "bitmap_or_reduce" else None
        rec["run_ms_per_launch"] = per
        rec["gap_ms"] = None if per is None else (per - rec["bound_ms"]) * rec["launches"]
        rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else None
        per_s = "not measured" if per is None else f"{per:.4f}"
        gap_s = "not measured" if per is None else f"{rec['gap_ms']:.3f}"
        log(f"    {rec['name']} @{rec['plane']} ({rec['path']}): {rec['launches']} | "
            f"{rec['ms']:.4f} | {per_s} | {rec['bound_ms']:.4f} ({rec['bytes'] / 1e6:.2f}) | "
            f"{gap_s}")
    return rows


def run_coverage(args, dev, card, phase, t_start, tmp) -> int:
    """``--coverage lm`` or ``--coverage graph``: its groups, the peak, the
    results (``--out``), the kernel sites' line (graph) and the ``ok``
    line."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    sites = []
    if args.coverage == "lm":
        out = run_lm_coverage(dev, args.seed, tmp, tuple(args.groups.split(",")), phase)
    else:
        out, sites = run_graph_coverage(args, dev, phase, args.cli_out)
    out["total_s"] = time.perf_counter() - t_start
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; total "
        f"{out['total_s']:.0f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                           coverage=args.coverage, results=out, args=vars(args)), f,
                      indent=1, default=lambda x: x.tolist() if hasattr(x, "tolist")
                      else float(x))
    if sites:
        print(json.dumps({"sites": sites}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=23)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=16)
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--torus-side", type=int, default=1024)
    ap.add_argument("--torus-roots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tri-scale", type=int, default=15,
                    help="Kronecker scale of the triangle count (15: the largest "
                         "whose adjacency rows the reference can address)")
    ap.add_argument("--bc-scale", type=int, default=12,
                    help="Kronecker scale held against host Brandes")
    ap.add_argument("--kcore-scale", type=int, default=14,
                    help="Kronecker scale held against host k-core peeling")
    ap.add_argument("--wave-scale", type=int, default=WAVE_SCALE,
                    help="Kronecker scale of the lane-packed repair")
    ap.add_argument("--cli-scale", type=int, default=CLI_SCALE,
                    help="Kronecker scale of the serving CLI's phase")
    ap.add_argument("--cli-seconds", type=float, default=CLI_SECONDS,
                    help="seconds of open-loop load in the serving CLI's phase")
    ap.add_argument("--cli-out", default=os.path.join(ROOT, "build", "serve_cli"),
                    help="where the serving CLI writes its stats, events and verdict")
    ap.add_argument("--out", default=None, help="also write the results here")
    ap.add_argument("--lm-only", action="store_true",
                    help="run the card line and the LM phases alone (with a profile of "
                         "decode steps and of a train step), for iterating on the LM path")
    ap.add_argument("--train-only", action="store_true",
                    help="run the card line, the LM training phase (with a profile of a "
                         "train step) and the multi-device phase alone")
    ap.add_argument("--multi-card", action="store_true",
                    help="on a machine with several cards: run the card line, phase "
                         "3c(d) over nccl with one rank on each card, and launch.train "
                         "under torchrun with nccl, alone (with --coverage lm: the four "
                         "families' serving over nccl alone)")
    ap.add_argument("--coverage", choices=("lm", "graph"), default=None,
                    help="run the card line and the paths the default run leaves out: "
                         "the LM side's (lm) or the traversals over the mesh, their kernel "
                         "sites, the per-group syncs and the serving stack (graph)")
    ap.add_argument("--groups", default=",".join(LM_GROUPS),
                    help=f"--coverage lm's groups to run, in order (of {','.join(LM_GROUPS)})")
    args = ap.parse_args(argv)
    if args.coverage == "lm" and not set(args.groups.split(",")) <= set(LM_GROUPS):
        ap.error(f"--groups: choose from {','.join(LM_GROUPS)}")
    if args.coverage == "lm":  # its models fill the card in blocks of many sizes
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", CHILD_ALLOC_CONF)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    def phase(msg):
        log(f"{msg} (at {time.perf_counter() - t_start:.0f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")

    phase("[1/27] card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    ck_tmp = tempfile.mkdtemp(prefix="repro_torch_restart_")
    try:
        return run_phases(args, dev, card, phase, t_start, ck_tmp)
    finally:
        shutil.rmtree(ck_tmp, ignore_errors=True)


def run_phases(args, dev, card, phase, t_start, ck_tmp) -> int:
    """Phases 2 to 27 (or 3, 3b and 3c alone); the restart's checkpoints
    under ``ck_tmp``."""
    import torch

    ck = os.path.join(ck_tmp, "ck")
    if args.multi_card:
        return run_multi_card(args, dev, card, phase, t_start)
    if args.coverage:
        return run_coverage(args, dev, card, phase, t_start, ck_tmp)
    if args.lm_only or args.train_only:
        lm_out = {}
        if args.lm_only:
            phase("[3/27] the LM serving path (alone)")
            lm_out = run_lm(dev, args.seed, profile_decode=True)
        phase("[3b/27] the LM training path (alone)")
        lm_out["train"] = run_train(dev, args.seed, profile=True, tmp=ck_tmp)
        phase("[3c/27] the LM multi-device half (alone)")
        lm_out["multi"] = run_multi(dev, args.seed, ck)
        phase("[3e/27] the LM's tensor parallelism (alone)")
        lm_out["tp"] = run_tp(dev, args.seed)
        phase(f"[3f/27] tensor parallelism for the other families ("
              f"{'serving' if args.lm_only else ''}"
              f"{' and ' if args.lm_only and args.train_only else ''}"
              f"{'training' if args.train_only else ''}, alone)")
        lm_out["tp_families"] = run_tp_families(dev, args.seed, serve=args.lm_only,
                                                train=args.train_only)
        phase("[3g/27] FSDP beside tensor parallelism (alone)")
        lm_out["fsdp"] = run_fsdp(dev, args.seed, serve=args.lm_only, train=args.train_only)
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; total "
            f"{time.perf_counter() - t_start:.0f} s")
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                               lm=lm_out, total_s=time.perf_counter() - t_start,
                               args=vars(args)), f, indent=1, default=float)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    dry_dir = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    dry_cli = start_dryrun_cli(dry_dir)
    try:
        return run_graph_phases(args, dev, card, phase, t_start, ck_tmp, ck, dry_cli,
                                dry_dir)
    finally:
        if dry_cli.poll() is None:
            dry_cli.kill()
            dry_cli.communicate()
        shutil.rmtree(dry_dir, ignore_errors=True)


def run_graph_phases(args, dev, card, phase, t_start, ck_tmp, ck, dry_cli, dry_dir) -> int:
    """Phases 2 to 27, the dry-run CLI of phase 3d(c) running beside them."""
    import numpy as np
    import torch

    from repro_torch import programs
    from repro_torch.analytics import msbfs
    from repro_torch.core import bfs
    from repro_torch.graph import generators
    from repro_torch.kernels import build

    phase("[2/27] build")
    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    log(f"  built {lib.relative_to(ROOT)} in {build_s:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "bytes stack frame" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    phase(f"[3/27] the LM serving path: {LM_ARCH} at its published size (bfloat16), "
          f"float32 consistency, every arch's reduced config against the CPU")
    lm_out = run_lm(dev, args.seed, profile_decode=False)
    log(f"  released the LM state: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    phase(f"[3b/27] the LM training path: {LM_ARCH} at its published size (bfloat16, "
          f"remat, AdamW), the butterfly gradient sync on {TRAIN_RANKS} ranks, restart, every "
          f"arch's reduced config against the CPU")
    lm_out["train"] = run_train(dev, args.seed, profile=False, tmp=ck_tmp)
    log(f"  released the training state: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated; peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    phase(f"[3c/27] the LM multi-device half: {LM_ARCH}'s placement on the production "
          f"meshes and data 2 x model 4, the elastic restore, GPipe (the gradient sync in "
          f"{DIST_WORLD} gloo processes beside phase 4)")
    lm_out["multi"] = run_multi(dev, args.seed, ck, gloo=False)
    shutil.rmtree(ck_tmp, ignore_errors=True)
    log(f"  released the multi-device state: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated; peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    phase(f"[3e/27] the LM's tensor parallelism: {LM_ARCH} sharded over data 2 x model 4 "
          f"(serving, a float32 step, training; the butterfly step in {TP_GLOO_WORLD} gloo "
          f"processes beside phase 4)")
    lm_out["tp"] = run_tp(dev, args.seed, gloo=False)
    log(f"  released the tensor-parallel state: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated; peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    phase("[3f/27] tensor parallelism for the other families on data 2 x model 4: "
          "mamba2-130m and whisper-medium at their published sizes, internvl2-26b at full "
          "width (2 layers), jamba-v0.1-52b at full width (one 8-layer period)")
    lm_out["tp_families"] = run_tp_families(dev, args.seed)
    log(f"  released the state of 3f: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated; peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    phase(f"[3g/27] FSDP (ZeRO-3) beside tensor parallelism on data 2 x model 4: "
          f"{FSDP_ARCH} at its published size (serving), at full width cut to "
          f"{FSDP_TRAIN_LAYERS} layers (training), a float32 step of the 2-layer cut (the "
          f"FSDP step in {TP_GLOO_WORLD} gloo processes beside phase 4)")
    lm_out["fsdp"] = run_fsdp(dev, args.seed, gloo=False)
    log(f"  released the state of 3g: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated; peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()

    # 3c(d) and 3e(d) hold the card in processes of their own while the
    # Kronecker graph is made on the host; it goes on the card after them
    beside = Beside(gloo_phases, dev, args.seed)
    phase("[4/27] ETL")
    kcfg = bfs.BFSConfig(fanout=args.fanout, sync="butterfly",
                         mode="direction_optimizing", use_kernels=True)
    tcfg = bfs.BFSConfig(fanout=args.fanout, sync="butterfly", mode="top_down",
                         use_kernels=True)
    try:
        kron = etl(f"kronecker scale {args.scale} EF {args.edge_factor}, weights 1..{WEIGHT}",
                   lambda: generators.kronecker(args.scale, args.edge_factor, seed=args.seed,
                                                max_weight=WEIGHT),
                   args.ranks, dev, kcfg.mode, before_place=beside.join)
    finally:
        gloo = beside.join()
    lm_out["multi"]["dist"], lm_out["tp"]["gloo"] = gloo["dist"], gloo["gloo"]
    lm_out["fsdp"]["gloo"] = gloo["fsdp"]
    torus = etl(f"torus {args.torus_side}x{args.torus_side}",
                lambda: generators.torus_2d(args.torus_side), args.ranks, dev,
                tcfg.mode)
    km, tm = kron["layout"].meta, torus["layout"].meta
    if not km["gather_full"] or tm["gather_full"]:
        raise AssertionError(f"expected a full-gather Kronecker layout and a "
                             f"windowed torus layout, got {km} / {tm}")
    wave_words = msbfs.wave_rows(kron["pg"]) * msbfs.lane_words(LANES)
    small = {}
    for what, scale in (("bc", args.bc_scale), ("kcore", args.kcore_scale),
                        ("tri", args.tri_scale)):
        small[what] = etl(f"kronecker scale {scale} EF {args.edge_factor} ({what})",
                          lambda scale=scale: generators.kronecker(
                              scale, args.edge_factor, seed=args.seed),
                          args.ranks, dev, "top_down")
        small[what]["scale"] = scale
    slice_words = {
        "bc_merge": ("bc", msbfs.wave_rows(kron["pg"]) * msbfs.lane_words(BC_LANES)),
        "kcore_merge": ("kcore", programs.program_msg_words(kron["pg"],
                                                           programs.by_name("kcore"))),
        "tri_merge": ("tri", programs.program_msg_words(small["tri"]["pg"],
                                                        programs.by_name("tri"))),
    }

    phase("[5/27] kernel checks at every call site (exact, at the paths' shapes)")
    floor_ms = event_floor_ms()
    log(f"  timing floor (a 4-byte fill, timed the same way): {floor_ms:.4f} ms")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []
    for cell, parts in (("kronecker", kron), ("torus", torus)):
        for case in site_cases(cell, parts, gen, dev, args.fanout):
            rows.append(check_kernel(case))
    merge_rows = []
    for case in merge_cases("kronecker", kron, gen, dev, args.fanout, wave_words):
        merge_rows.append(check_kernel(case))
        del case["args"]
    for case in slice_merge_cases(gen, dev, args.ranks, args.fanout, slice_words):
        merge_rows.append(check_kernel(case))
        del case["args"]
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    phase("[6/27] edge cases of the scatter and both gathers (exact, every route)")
    n_edge = edge_cases(gen, dev)

    phase(f"[7/27] Kronecker BFS: direction_optimizing, butterfly fanout "
        f"{args.fanout}, kernels, {args.roots} roots")
    kron_sum, kron_launch, kron_profile, _ = run_bfs(
        "kronecker", kron, kcfg, args.roots, args.seed, dev)

    phase(f"[8/27] torus BFS: top_down, butterfly fanout {args.fanout}, kernels, "
        f"{args.torus_roots} roots")
    torus_sum, torus_launch, torus_profile, torus_again = run_bfs(
        "torus", torus, tcfg, args.torus_roots, args.seed, dev)

    phase("[9/27] kernel launches on the main path (phases 7 and 8)")
    records = []
    for name, (cell, plane, act) in MAIN_SITE.items():
        rec = next(dict(r) for r in rows if r["name"] == name and r["cell"] == cell
                   and r["plane"] == plane and r.get("activity") == act)
        for key in ("cell", "plane", "activity", "bytes"):
            rec.pop(key, None)
        rec["launches"] = kron_launch[name] + torus_launch[name]
        records.append(rec)
    idle = [r["name"] for r in records if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    log("  " + ", ".join(f"{r['name']} {r['launches']}" for r in records))
    for label, summary in (("kronecker", kron_sum), ("torus", torus_sum)):
        log(f"  {label} launches per BFS by site: " + ", ".join(
            f"{k.split(':')[1]} {v:.2f}" for k, v in summary["site_launches_per_bfs"].items()))

    phase("[3d/27, continued] the roofline terms: the BFS cell at phase 7's partition, "
          "the dry-run CLI")
    roof = {"train_step": lm_out["train"]["published"]["roofline"],
            "bfs_cell": roofline_bfs(kron, kcfg, kron_sum["first_root"], dev),
            "cli": finish_dryrun_cli(dry_cli, dry_dir)}

    phase(f"[10/27] the other syncs, every one through the kernels ({SYNC_ROOTS} roots "
        f"each, {4 * SYNC_ROOTS} for adaptive Kronecker)")
    paths, profiles = {}, {}
    cells = [("kronecker", kron, kcfg, "adaptive", 4 * SYNC_ROOTS)]
    cells += [("kronecker", kron, kcfg, s, SYNC_ROOTS)
              for s in ("sparse", "rabenseifner", "xla")]
    cells += [("torus", torus, tcfg, "adaptive", SYNC_ROOTS)]
    for cell, parts, base, sync, n in cells:
        label = f"{cell} {sync}"
        paths[label], profiles[label], base_run = run_sync_cell(
            label, parts, dataclasses.replace(base, sync=sync), base, n, args.seed, dev)
        if cell == "torus":  # 1025 levels: a profile would cost minutes
            del profiles[label]
        elif sync == "adaptive":
            profiles[f"{cell} butterfly, the same root"] = base_run
    buf = random_words((args.ranks, torus["pg"].n_words), gen, dev, density=0.001)
    paths["torus adaptive"]["decision_ms"] = decision_ms(buf)
    buf = random_words((args.ranks, kron["pg"].n_words), gen, dev, density=0.001)
    paths["kronecker adaptive"]["decision_ms"] = decision_ms(buf)
    del buf
    for label in ("kronecker adaptive", "torus adaptive"):
        per_level = paths[label]["trimmed_ms"] / np.mean(paths[label]["levels"])
        log(f"  {label}: one adaptive decision (two counts on the device and their "
            f"read) {paths[label]['decision_ms']:.4f} ms host, against "
            f"{per_level:.4f} ms a level of the trimmed BFS")

    phase(f"[10b/27] the hierarchical mesh: Kronecker BFS on pod {args.ranks // 4} x data 4 "
          f"under every sync against the one-axis run; the analysis tools")
    slice8 = {}
    slice8["axes_bfs"], slice8["axes_launches"], (f2_path, f2_run), f2_merge = run_axes_bfs(
        kron, args.fanout, args.seed, dev, gen)
    paths["axes butterfly fanout 2"], profiles["axes butterfly fanout 2"] = f2_path, f2_run
    merge_rows.append(f2_merge)
    slice8["tools"] = run_tools(kron, args.scale, args.edge_factor)
    torch.cuda.empty_cache()

    phase(f"[11/27] multi-source BFS: one {LANES}-lane Kronecker wave, "
          f"direction_optimizing")
    single = bfs.build_bfs_fn(kron["pg"], kcfg, kron["layout"], device=dev)
    for sync in ("butterfly", "adaptive"):
        label = f"wave {sync}"
        wcfg = bfs.BFSConfig(fanout=args.fanout, sync=sync, mode="direction_optimizing")
        paths[label], profiles[label] = run_wave(label, kron, wcfg, LANES, args.seed,
                                                 dev, single)
        torch.cuda.empty_cache()

    slice5, sssp_rows = {}, {}
    phase(f"[12/27] SSSP: weighted Kronecker, "
          f"{', '.join(f'{k} {v} roots' for k, v in SSSP_ROOTS.items())}, butterfly "
          f"delta {SSSP_DELTA} 1 root")
    slice5.update(run_sssp(kron, args.fanout, args.seed, dev, SSSP_ROOTS, SSSP_DELTA,
                           keep=sssp_rows))
    torch.cuda.empty_cache()

    phase(f"[13/27] betweenness centrality: one {BC_LANES}-lane Kronecker wave, top_down, "
          f"butterfly; scale {args.bc_scale} against host Brandes")
    paths["bc"], profiles["bc"] = run_bc(kron, args.fanout, args.seed, dev, single,
                                         BC_LANES, small["bc"])
    torch.cuda.empty_cache()

    phase("[14/27] PageRank: butterfly and sparse (delta)")
    ranks = {}
    slice5.update(run_pagerank(kron, args.fanout, dev, keep=ranks))
    torch.cuda.empty_cache()

    phase("[15/27] connected components: butterfly and adaptive")
    slice5.update(run_cc(kron, args.fanout, dev))
    torch.cuda.empty_cache()

    phase("[10b/27, continued] SSSP and CC on the hierarchical mesh against phases 12 and 15")
    slice8["axes_weighted"] = run_axes_weighted(kron, args.fanout, dev, sssp_rows, slice5)
    torch.cuda.empty_cache()

    phase(f"[16/27] k-core: Kronecker, butterfly; scale {args.kcore_scale} against the host")
    paths["kcore"], profiles["kcore"] = run_kcore(kron, args.fanout, dev, small["kcore"])
    torch.cuda.empty_cache()

    phase(f"[17/27] triangles: Kronecker scale {args.tri_scale}, butterfly, against the host")
    paths["tri"], profiles["tri"] = run_triangles(small["tri"], args.fanout, dev)
    torch.cuda.empty_cache()

    phase(f"[18/27] lane-packed repair: Kronecker scale {args.wave_scale}, "
          f"{WAVE_SUSPECTS} rows in two {LANES}-lane waves")
    paths["repair wave"], profiles["repair wave"], wave_width = run_wave_repair(
        args.wave_scale, args.edge_factor, args.ranks, args.fanout, args.seed, dev)
    torch.cuda.empty_cache()

    phase(f"[19/27] mutation batches on a copy of the Kronecker partition, in place, "
          f"and single-row repair ({REPAIR_ROOTS} roots: BFS under "
          f"{', '.join(REPAIR_SYNCS)}, SSSP under butterfly)")
    from repro_torch.traversal import sssp

    mut = mutation_setup(kron, args.fanout, args.seed, dev, REPAIR_ROOTS)
    slice6 = dict(slack_out=mut["slack_out"], slack_in=mut["slack_in"])
    for label, n_del in (("insert-only", 0), ("mixed", MUTATION_DELETES)):
        batch, kept = fitting_batch(mut["overlay"], mut["pg"], mut["rng"], MUTATION_INSERTS,
                                    n_del, WEIGHT)
        slice6[label], rerun = repair_batch(label, mut, batch, dev)
        slice6[label]["kept_inserts"] = kept
    paths["repair butterfly"], profiles["repair butterfly"] = slice6["mixed"]["first"], rerun
    slice6["unchanged"] = unchanged_batch(mut, dev)
    torch.cuda.empty_cache()

    phase(f"[20/27] a batch of {OVERFLOW_FRACTION:g} of the edges: refused in place "
          f"atomically, then compaction and repartition")
    slice6["overflow"] = overflow_batch(mut, args.fanout, dev, args.ranks)
    torch.cuda.empty_cache()

    phase("[21/27] query engine: BFS waves with duplicates, SSSP, CC, the program "
          "cache, refresh after the patches")
    paths["engine"] = run_engine(kron, args.fanout, args.seed, dev, single, sssp_rows, mut)
    repair_width = sssp.dist_rows(mut["pg"]) // 32
    del mut
    torch.cuda.empty_cache()

    phase("[22/27] bitmap_or_reduce at the repair's OR-sync shapes (exact, timed)")
    for case in slice_merge_cases(gen, dev, args.ranks, args.fanout, {
            "repair_or": ("repair butterfly", repair_width),
            "repair_wave_or": ("repair wave", wave_width)}):
        merge_rows.append(check_kernel(case))
        del case["args"]
        torch.cuda.empty_cache()

    phase("[23/27] the query service at full size: a seeded request stream, then a "
          "mutation batch through apply_updates")
    del batch, rerun, case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  released phases 18-22's state: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated (the repair paths' profile runs keep theirs)")
    slice7 = {"service": run_service(kron, args.fanout, args.seed, dev, single, sssp_rows,
                                     ranks)}
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[24/27] the serving CLI: Kronecker scale {args.cli_scale}, 2 replicas, "
          f"chaos {CLI_CHAOS!r}, mutations, events, SLOs")
    slice7["cli"] = run_serving_cli(args.cli_scale, args.edge_factor, args.ranks,
                                    args.fanout, args.seed, args.cli_out,
                                    seconds=args.cli_seconds)
    gc.collect()
    torch.cuda.empty_cache()

    phase("[25/27] the cost-model profiler: engine.profile on the kernel path")
    slice7["profiler"] = run_profiler(kron, args.fanout, dev, kron_sum["first_root"], single)

    phase("[26/27] profiles (one root each), then the torus roots timed again")
    kron_sum["profile"] = kron_profile()
    torus_sum["profile"] = torus_profile()
    same_root = {}
    for label, run in profiles.items():
        torch.cuda.empty_cache()
        prof = merge_profile(label, run)
        (paths[label] if label in paths else same_root.setdefault(label, {}))["profile"] = prof
    _, torus_sum["after_profiler_ms"], _ = torus_again()
    log(f"  torus trimmed mean after the profiler: "
        f"{torus_sum['after_profiler_ms']:.3f} ms (before it: "
        f"{torus_sum['trimmed_ms']:.3f} ms)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"total {time.perf_counter() - t_start:.0f} s")

    phase("[27/27] result")
    site_table(rows, {"kronecker": kron_sum, "torus": torus_sum})
    for label, path in paths.items():
        launches = path["traced_launches"] if "traced_launches" in path else path["launches"]
        path["merge_launches_per_run"] = launches.get("bitmap_or_reduce", 0)
    paths["kronecker rabenseifner"]["sites_sharing"] = sum(
        r["path"] == "kronecker rabenseifner" for r in merge_rows)
    # the dense levels of the sparse syncs merge at the butterfly's shapes
    for path, cell, plane in (("kronecker adaptive", "kronecker", "merge"),
                              ("kronecker sparse", "kronecker", "merge"),
                              ("torus adaptive", "torus", "merge"),
                              ("wave adaptive", "kronecker", "wave_merge")):
        src = next(r for r in rows + merge_rows if r["cell"] == cell and r["plane"] == plane)
        merge_rows.append(dict(src, path=path, plane=f"{plane} (dense levels)"))
    merge_site_table(merge_rows, paths)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           kernels=records, sites=rows, merge_sites=merge_rows,
                           slice5=slice5, slice6=slice6, slice7=slice7, slice8=slice8,
                           roofline=roof, lm=lm_out,
                           edge_cases=n_edge, timing_floor_ms=floor_ms,
                           kronecker=kron_sum, torus=torus_sum, paths=paths,
                           same_root=same_root,
                           kronecker_launches=kron_launch,
                           torus_launches=torus_launch,
                           etl_s={"kronecker": kron["etl_s"], "torus": torus["etl_s"]},
                           device_bytes={"kronecker": kron["device_bytes"],
                                         "torus": torus["device_bytes"]},
                           total_s=time.perf_counter() - t_start,
                           args=vars(args)), f, indent=1, default=float)
    print(json.dumps({"sites": rows + merge_rows}, default=float), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
