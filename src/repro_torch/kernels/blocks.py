"""Host-side edge-block layout ETL for the frontier kernels (NumPy).

A copy of ``repro.kernels.blocks``; its output is identical to the
reference's.  At ETL time (once per graph) edges are cut into fixed-size
blocks of ``eb`` slots with precomputed bitmap windows, the stand-in for
the paper's LRB binning: every block does identical work and touches a
bounded window of the bitmap.  All layout arrays are static across BFS
levels.  The CUDA scatter kernel zero-fills its output and ORs every block
in with atomics, so it does not read ``block_first``; the array is kept so
that the layout stays identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tracing import span
from repro_torch.graph.csr import WORD_BITS


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


@dataclasses.dataclass
class GatherLayout:
    """Edges (sorted by src) cut into NB blocks of EB; per-block bitmap
    window of ``ww`` words starting at word ``block_ws * ww``."""

    ww: int
    words_pad: int
    block_ws: np.ndarray  # int32[NB]
    src_local: np.ndarray  # int32[NB, EB]
    full: bool = False  # True -> spans too wide; use full-bitmap kernel


@dataclasses.dataclass
class ScatterLayout:
    """Edges (sorted by dst) grouped per ``ww``-word output window, cut into
    NB blocks of EB.  Every window owns >= 1 block (possibly empty) so every
    output tile is written; blocks of one window are consecutive."""

    ww: int
    words_pad: int
    n_windows: int
    block_win: np.ndarray  # int32[NB]
    block_first: np.ndarray  # int32[NB]
    dst_local: np.ndarray  # int32[NB, EB]  (== ww*32 marks invalid slot)
    perm: np.ndarray  # int32[NB, EB]  index into the flat gather-order bits


def required_gather_ww(src_sorted: np.ndarray, count: int, eb: int, min_ww: int = 8) -> int:
    """Smallest power-of-two window (words) covering every block's src span."""
    src = np.asarray(src_sorted[:count])
    if count == 0:
        return min_ww
    nb = -(-count // eb)
    ww = min_ww
    firsts = src[np.arange(nb) * eb] >> 5
    lasts = src[np.minimum(np.arange(1, nb + 1) * eb, count) - 1] >> 5
    while True:
        ws = firsts // ww
        if np.all(lasts < (ws + 1) * ww):
            return ww
        ww *= 2


def build_gather_layout(
    src_sorted: np.ndarray,
    count: int,
    n_words: int,
    *,
    eb: int = 512,
    ww: Optional[int] = None,
    max_ww: int = 4096,
) -> GatherLayout:
    src = np.asarray(src_sorted[:count], dtype=np.int64)
    nb = max(1, -(-count // eb))
    if ww is None:
        ww = required_gather_ww(src_sorted, count, eb)
    if ww > max_ww:
        # too sparse for windowing: whole bitmap per block
        words_pad = _round_up(n_words, 128)
        src_pad = np.zeros(nb * eb, dtype=np.int32)
        src_pad[:count] = src
        return GatherLayout(
            ww=words_pad,
            words_pad=words_pad,
            block_ws=np.zeros(nb, np.int32),
            src_local=src_pad.reshape(nb, eb),
            full=True,
        )
    words_pad = _round_up(n_words, ww)
    block_ws = np.zeros(nb, dtype=np.int32)
    src_local = np.zeros((nb, eb), dtype=np.int32)
    for b in range(nb):
        blk = src[b * eb : (b + 1) * eb]
        if blk.size:
            ws = int(blk[0] >> 5) // ww
            block_ws[b] = ws
            src_local[b, : blk.size] = blk - ws * ww * WORD_BITS
    return GatherLayout(ww=ww, words_pad=words_pad, block_ws=block_ws, src_local=src_local)


def build_scatter_layout(
    dst_sorted: np.ndarray,
    order: np.ndarray,
    count: int,
    n_words: int,
    *,
    eb: int = 512,
    ww: int = 64,
) -> ScatterLayout:
    """``dst_sorted``/``order``: destination-sorted edge dsts and their
    indices in the flat gather-order active array."""
    words_pad = _round_up(n_words, ww)
    n_windows = words_pad // ww
    bits = ww * WORD_BITS
    dst = np.asarray(dst_sorted[:count], dtype=np.int64)
    order = np.asarray(order[:count], dtype=np.int64)
    win_of = (dst >> 5) // ww
    # boundaries of each window's edge range (dst sorted => win_of sorted)
    starts = np.searchsorted(win_of, np.arange(n_windows), side="left")
    ends = np.searchsorted(win_of, np.arange(n_windows), side="right")
    rows_win: List[int] = []
    rows_first: List[int] = []
    rows_dst: List[np.ndarray] = []
    rows_perm: List[np.ndarray] = []
    for w in range(n_windows):
        lo, hi = int(starts[w]), int(ends[w])
        n_blk = max(1, -(-(hi - lo) // eb))
        for b in range(n_blk):
            s = lo + b * eb
            e = min(lo + (b + 1) * eb, hi)
            dl = np.full(eb, bits, dtype=np.int32)
            pm = np.zeros(eb, dtype=np.int32)
            if e > s:
                dl[: e - s] = dst[s:e] - w * bits
                pm[: e - s] = order[s:e]
            rows_win.append(w)
            rows_first.append(1 if b == 0 else 0)
            rows_dst.append(dl)
            rows_perm.append(pm)
    return ScatterLayout(
        ww=ww,
        words_pad=words_pad,
        n_windows=n_windows,
        block_win=np.array(rows_win, dtype=np.int32),
        block_first=np.array(rows_first, dtype=np.int32),
        dst_local=np.stack(rows_dst),
        perm=np.stack(rows_perm),
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_blocks(arrs: List[np.ndarray], nb: int, pad_row) -> np.ndarray:
    """Stack per-device block arrays to [P, nb, ...], padding each with
    ``pad_row(a)`` (a row shaped like ``a.shape[1:]``)."""
    out = []
    for a in arrs:
        if a.shape[0] < nb:
            row = np.asarray(pad_row(a))
            pad = np.broadcast_to(row, (nb - a.shape[0],) + a.shape[1:]).copy()
            a = np.concatenate([a, pad], axis=0)
        out.append(a)
    return np.stack(out)


@dataclasses.dataclass
class BFSKernelLayout:
    """Device-stacked layouts for the whole BFS (top-down + bottom-up)."""

    # static: eb, gather ww/full, scatter ww, words_pad..., and the planes
    # whose ids are sorted (``sorted_planes``)
    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]  # [P, ...] stacked, shard over device axis


def build_bfs_layout(pg, *, eb: int = 512, scatter_ww: int = 64) -> BFSKernelLayout:
    """Build stacked kernel layouts for a :class:`PartitionedGraph` (an
    ``etl.build_bfs_layout`` span; its loops over the ranks in
    ``etl.build_bfs_layout.ranks`` spans, one a stage)."""
    with span("etl.build_bfs_layout"):
        p = pg.p
        # -- top-down gather (edge_src is (src,dst)-sorted)
        with span("etl.build_bfs_layout.ranks"):
            ww_g = max(
                required_gather_ww(pg.edge_src[i], int(pg.edge_count[i]), eb) for i in range(p)
            )
            g_layouts = [
                build_gather_layout(
                    pg.edge_src[i], int(pg.edge_count[i]), pg.n_words, eb=eb, ww=ww_g
                )
                for i in range(p)
            ]
            full = any(g.full for g in g_layouts)
            if full:  # rebuild all in full mode for uniformity
                g_layouts = [
                    build_gather_layout(
                        pg.edge_src[i], int(pg.edge_count[i]), pg.n_words, eb=eb, ww=10**9
                    )
                    for i in range(p)
                ]
            nb_g = max(g.block_ws.shape[0] for g in g_layouts)

        # -- top-down scatter (re-sort owned edges by dst)
        with span("etl.build_bfs_layout.ranks"):
            s_layouts = []
            for i in range(p):
                c = int(pg.edge_count[i])
                order = np.argsort(pg.edge_dst[i, :c], kind="stable")
                s_layouts.append(
                    build_scatter_layout(
                        pg.edge_dst[i, :c][order], order, c, pg.n_words, eb=eb, ww=scatter_ww
                    )
                )
            nb_s = max(s.block_win.shape[0] for s in s_layouts)

        # -- bottom-up: full gather over in_src / windowed gather over in_dst,
        #    scatter along in_dst (already dst-sorted, identity order)
        with span("etl.build_bfs_layout.ranks"):
            ww_pd = max(
                required_gather_ww(pg.in_dst[i], int(pg.in_count[i]), eb) for i in range(p)
            )
            pd_layouts = [
                build_gather_layout(
                    pg.in_dst[i], int(pg.in_count[i]), pg.n_words, eb=eb, ww=ww_pd
                )
                for i in range(p)
            ]
        with span("etl.build_bfs_layout.ranks"):
            ps_layouts = []
            for i in range(p):
                c = int(pg.in_count[i])
                ps_layouts.append(
                    build_scatter_layout(
                        pg.in_dst[i, :c],
                        np.arange(c),
                        c,
                        pg.n_words,
                        eb=eb,
                        ww=scatter_ww,
                    )
                )
            nb_ps = max(s.block_win.shape[0] for s in ps_layouts)
        nb_in = max(1, -(-pg.emax // eb))  # in_src full-gather chunk blocks

        in_src_b = np.zeros((p, nb_in, eb), np.int32)
        with span("etl.build_bfs_layout.ranks"):
            for i in range(p):
                flat = pg.in_src[i]
                in_src_b[i].reshape(-1)[: flat.shape[0]] = flat

        def stack_gather(ls, nb):
            ws = _pad_blocks([l.block_ws for l in ls], nb, lambda a: np.int32(0))
            sl = _pad_blocks(
                [l.src_local for l in ls], nb, lambda a: np.zeros(a.shape[1:], np.int32)
            )
            return ws, sl

        def stack_scatter(ls, nb):
            # padding blocks repeat the last window id (keeps block_win sorted)
            # with first=0 and all-invalid slots -> they OR nothing.
            bw = _pad_blocks([l.block_win for l in ls], nb, lambda a: a[-1])
            bf = _pad_blocks([l.block_first for l in ls], nb, lambda a: np.int32(0))
            dl = _pad_blocks(
                [l.dst_local for l in ls],
                nb,
                lambda a: np.full(a.shape[1:], scatter_ww * 32, np.int32),
            )
            pm = _pad_blocks(
                [l.perm for l in ls], nb, lambda a: np.zeros(a.shape[1:], np.int32)
            )
            return bw, bf, dl, pm

        # the ranks' layouts padded and stacked
        with span("etl.build_bfs_layout.ranks"):
            tg_ws, tg_src = stack_gather(g_layouts, nb_g)
            ts_bw, ts_bf, ts_dl, ts_pm = stack_scatter(s_layouts, nb_s)
            nb_pd = max(l.block_ws.shape[0] for l in pd_layouts)
            pg_ws, pg_dst = stack_gather(pd_layouts, nb_pd)
            ps_bw, ps_bf, ps_dl, ps_pm = stack_scatter(ps_layouts, nb_ps)

        meta = dict(
            eb=eb,
            gather_ww=g_layouts[0].ww,
            gather_full=int(full),
            gather_words_pad=g_layouts[0].words_pad,
            pull_gather_ww=pd_layouts[0].ww,
            pull_gather_full=int(pd_layouts[0].full),
            pull_gather_words_pad=pd_layouts[0].words_pad,
            scatter_ww=scatter_ww,
            scatter_words_pad=s_layouts[0].words_pad,
            scatter_windows=s_layouts[0].n_windows,
            nb_in=nb_in,
            # full-gather planes whose ids ascend within each rank: out-edge
            # sources (edge_src is sorted) and in-edge destinations; in_src_blocks
            # follows in_dst's order, so its sources are not sorted
            sorted_planes=("tdg_src", "pug_dst"),
        )
        arrays = dict(
            tdg_ws=tg_ws,
            tdg_src=tg_src,
            tds_win=ts_bw,
            tds_first=ts_bf,
            tds_dst=ts_dl,
            tds_perm=ts_pm,
            pug_ws=pg_ws,
            pug_dst=pg_dst,
            pus_win=ps_bw,
            pus_first=ps_bf,
            pus_dst=ps_dl,
            pus_perm=ps_pm,
            in_src_blocks=in_src_b,
        )
        return BFSKernelLayout(meta=meta, arrays=arrays)
