"""Single-source searches, one at a time, through ``run`` of the port's
``core/bfs.build_bfs_fn``: the deployment's ranks, fanout and sync, the
mix's direction mode, and the CUDA kernels when the mix asks for them."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from bench import graph, harness
from bench.reference import INF


def inputs(config: dict, traffic: dict, seed: int, device: torch.device) -> graph.Inputs:
    return graph.Inputs(config, traffic, seed, device, Path(__file__).parents[1])


class Driver:
    """Set-up (the port's ETL and placement), one search a step, its
    replay with a Communicator, the control, and the check."""

    def __init__(self, config: dict, traffic: dict, inputs: graph.Inputs,
                 device: torch.device, stages: harness.Stages):
        from repro_torch.core import bfs
        from repro_torch.kernels import blocks

        pg = graph.partition(inputs.tuples, config, stages)
        self.cfg = bfs.BFSConfig(**graph.bfs_knobs(config, traffic))
        self.layout = None
        if self.cfg.use_kernels:
            with stages("build_bfs_layout"):
                self.layout = blocks.build_bfs_layout(pg)
        with stages("place_arrays"):
            self.arrays = bfs.place_arrays(pg, self.layout, device=device)
        self.pg, self.device, self.inputs = pg, device, inputs
        self.fn = bfs.build_bfs_fn(pg, self.cfg, self.layout, device=device)
        self.wait = bfs.device_sync(device)
        # where each rank's owned depths sit in the global order
        self.v_start, self.v_count = pg.v_start.copy(), pg.v_count.copy()

    def step(self, roots: np.ndarray) -> torch.Tensor:
        d_owned = self.fn(self.arrays, int(roots[0]))[0]
        self.wait()
        return d_owned

    def replay(self, units) -> dict:
        """The searches again, their sync counted in a Communicator: their
        levels, and the bytes the largest rank sent."""
        from repro_torch.core import collectives

        comm = collectives.Communicator(self.pg.p, self.device)
        levels = sum(self.fn(self.arrays, int(roots[0]), comm)[1] for roots in units)
        return {"levels": int(levels), "sync_bytes": int(comm.bytes_sent.max())}

    def control(self, roots: np.ndarray, d_owned: torch.Tensor) -> torch.Tensor:
        """The search again under the port's own level limit, set one level
        short of the deepest depth it found: its deepest vertices go
        unreached."""
        from repro_torch.core import bfs

        deepest = int(d_owned[d_owned < INF].max())
        cfg = dataclasses.replace(self.cfg, max_levels=deepest - 1)
        fn = bfs.build_bfs_fn(self.pg, cfg, self.layout, device=self.device)
        return fn(self.arrays, int(roots[0]))[0]

    def depths(self, d_owned: torch.Tensor, lane: int) -> torch.Tensor:
        """The port's per-rank depths ``[P, vmax]`` in global vertex order."""
        n = int(self.v_start[-1]) + int(self.v_count[-1])
        out = torch.full((n,), INF, dtype=torch.int32, device=self.device)
        for i, (s, c) in enumerate(zip(self.v_start.tolist(), self.v_count.tolist())):
            out[s:s + c] = d_owned[i, :c].to(self.device)
        return out

    def close(self) -> None:
        del self.arrays, self.fn, self.layout, self.pg

    def check(self, units, samples, controls) -> harness.Verdict:
        return graph.check(self.inputs, self.device, units, samples, controls, self.depths)
