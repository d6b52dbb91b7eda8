"""Waves of searches through ``BFSQueryEngine.query`` of the port's
``analytics/engine.py``: the mix's roots packed ``lanes`` to a wave, one
wave a step, each answered as the engine answers (distances on the host)."""

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
    """Set-up (the port's ETL; the engine places the arrays and builds its
    wave program), one ``query`` of a wave a step, the wave's replay with a
    Communicator, the control, and the check."""

    def __init__(self, config: dict, traffic: dict, inputs: graph.Inputs,
                 device: torch.device, stages: harness.Stages):
        from repro_torch.analytics.engine import BFSQueryEngine
        from repro_torch.core import bfs

        pg = graph.partition(inputs.tuples, config, stages)
        self.cfg = bfs.BFSConfig(**graph.bfs_knobs(config, traffic))
        self.lanes = int(traffic["lanes"])
        with stages("engine"):
            self.engine = BFSQueryEngine(pg, self.cfg, lanes=self.lanes, device=device)
        self.pg, self.device, self.inputs = pg, device, inputs

    def step(self, roots: np.ndarray) -> np.ndarray:
        return self.engine.query(roots)

    def _wave(self, cfg, roots: np.ndarray, comm=None):
        """The engine's wave program for ``cfg`` run on the engine's placed
        arrays (``roots`` fill the wave; ``-1`` pads it)."""
        from repro_torch.analytics import engine

        fn = engine.compiled_wave_fn(self.pg, self.device, cfg, self.lanes, self.engine.mesh)
        padded = np.full(self.lanes, -1, dtype=np.int64)
        padded[:roots.size] = roots
        return fn(self.engine._arrays, padded, comm)

    def replay(self, units) -> dict:
        """The waves again, their sync counted in a Communicator: their
        levels, and the bytes the largest rank sent."""
        from repro_torch.core import collectives

        comm = collectives.Communicator(self.engine.mesh, self.device)
        levels = sum(self._wave(self.cfg, roots, comm)[1] for roots in units)
        return {"levels": int(levels), "sync_bytes": int(comm.bytes_sent.max())}

    def control(self, roots: np.ndarray, dist: np.ndarray) -> np.ndarray:
        """The wave again under the port's own level limit, one level short
        of the deepest depth it found: the deepest vertices go unreached."""
        from repro_torch.analytics import msbfs

        deepest = int(dist[dist < INF].max())
        cfg = dataclasses.replace(self.cfg, max_levels=deepest - 1)
        return msbfs.assemble_distances(self.pg, self._wave(cfg, roots)[0], roots.size)

    def depths(self, dist: np.ndarray, lane: int) -> torch.Tensor:
        return torch.from_numpy(dist[lane]).to(self.device)

    def close(self) -> None:
        del self.engine, self.pg

    def check(self, units, samples, controls) -> harness.Verdict:
        return graph.check(self.inputs, self.device, units, samples, controls, self.depths)
