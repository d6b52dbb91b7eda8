"""What the traversal drivers share: the graph's tuples and search keys made
from the seed, the port's ETL of them, and the check of the sampled
searches' depths against :mod:`bench.reference`, with Graph500's count of
each unit's work."""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from bench import harness, reference


def search_keys(src: torch.Tensor, dst: torch.Tensor, n: int,
                gen: torch.Generator) -> np.ndarray:
    """Every vertex of degree 1 or more, self-loops not counted (Graph500's
    rule for search keys), in an order drawn from ``gen``."""
    keep = src != dst
    deg = torch.bincount(src[keep], minlength=n) + torch.bincount(dst[keep], minlength=n)
    cand = torch.nonzero(deg > 0).flatten()
    order = torch.randperm(cand.numel(), generator=gen, device=cand.device)
    return cand[order].cpu().numpy()


class Inputs:
    """The configuration's tuples, drawn on the device by its generator
    (``generators/<config's "generator">.py``) from its ``graph_seed``,
    and kept on the host; and the search keys in an order drawn from the
    run's seed, handed out ``lanes`` (the mix's, 1 by default) to a unit.
    One graph a configuration, whatever the seed: the work of a run does
    not change with it.  ``bench`` is the benchmark's directory."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 bench: Path):
        gen = harness.load_module(bench / "generators" / f"{config['generator']}.py")
        n, src, dst = gen.edges(config, harness.seeded(config["graph_seed"], device), device)
        self.keys = search_keys(src, dst, n, harness.seeded(seed, device)).astype(np.int64)
        self.n, self.src, self.dst = n, src.cpu().numpy(), dst.cpu().numpy()
        self.lanes, self.taken = int(traffic.get("lanes", 1)), 0

    @property
    def tuples(self):
        return self.n, self.src, self.dst

    def next_unit(self) -> np.ndarray:
        k = self.lanes
        if self.taken + k > self.keys.size:
            raise RuntimeError(f"the run used all {self.keys.size} search keys")
        self.taken += k
        return self.keys[self.taken - k:self.taken]


def bfs_knobs(config: dict, traffic: dict) -> dict:
    """``BFSConfig`` arguments: the deployment's fanout and sync (a mix may
    name another sync), the mix's direction mode and kernel switch."""
    return dict(fanout=int(config["fanout"]), sync=traffic.get("sync", config["sync"]),
                mode=traffic["mode"], use_kernels=bool(traffic.get("use_kernels", False)))


def partition(tuples, config: dict, stages: harness.Stages):
    """The port's ETL of the tuples: ``csr.from_edges`` (symmetrize, drop
    self-loops and repeats), then ``partition.partition_1d`` over the
    deployment's ranks."""
    from repro_torch.graph import csr
    from repro_torch.graph import partition as part

    n, src, dst = tuples
    with stages("from_edges"):
        g = csr.from_edges(src, dst, n)
    with stages("partition_1d"):
        return part.partition_1d(g, int(config["ranks"]))


def mismatches(ref: reference.Reference, root: int, got: torch.Tensor) -> int:
    """Vertices whose depth ``got`` (the port's, global, any int dtype)
    differs from the reference's BFS from ``root``."""
    want = ref.depths(int(root))
    return int((got[: want.numel()].long() != want.long()).sum())


def check(inputs: Inputs, device: torch.device, units, samples, controls,
          depths: Callable) -> harness.Verdict:
    """The reference built from the tuples alone; every sampled search's
    depths (``depths(out, lane)``) compared with it vertex by vertex
    (``mismatched_depths``, limit 0), the control's likewise; and each
    unit's Graph500 work (``tuples``): the generated tuples inside each of
    its roots' components."""
    n, src, dst = inputs.tuples
    ref = reference.Reference(torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
                              n)
    roots = np.concatenate([u.requests for u in units])
    per_root = ref.tuples_in(roots).cpu().numpy()
    tuples = np.add.reduceat(per_root, np.cumsum([0] + [u.size for u in units[:-1]]))
    compared = failed = wrong = 0
    for unit, out in samples:
        for lane, root in enumerate(unit.requests):
            bad = mismatches(ref, root, depths(out, lane))
            compared += 1
            failed += int(bad > 0)
            wrong += bad
    control = None
    if controls is not None:
        control = sum(mismatches(ref, root, depths(out, lane))
                      for (unit, _), out in zip(samples, controls)
                      for lane, root in enumerate(unit.requests))
    return harness.Verdict(checks={"mismatched_depths": (wrong, 0)}, compared=compared,
                           failed=failed, counts={"tuples": tuples}, control=control)
