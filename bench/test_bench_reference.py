"""The plain reference against a brute-force count and against the port, at
small scale on the CPU; the control fails where the port passes."""

import collections

import numpy as np
import pytest
import torch

from bench import harness, reference
from bench.fixtures import card, one_thread, small_copy, small_root  # noqa: F401
from bench.generators import gap_uniform, graph500_kronecker

SEED = 2**31 + 11
CELLS = ("kron23.bfs", "urand22.bfs", "kron23.waves32")


def kron(scale, seed=SEED):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return graph500_kronecker.edges({"scale": scale, "edge_factor": 8, "A": 0.57, "B": 0.19,
                                     "C": 0.19}, gen, torch.device("cpu"))


def brute(n, src, dst, root):
    """Depths by a queue over adjacency sets, and the tuples (self-loops and
    repeats included) whose tail the search reached."""
    adj = collections.defaultdict(set)
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].add(b)
        adj[b].add(a)
    depth, queue = {root: 0}, [root]
    for v in queue:
        for w in adj[v]:
            if w not in depth:
                depth[w] = depth[v] + 1
                queue.append(w)
    count = sum(1 for a in src.tolist() if a in depth)
    return [depth.get(v, reference.INF) for v in range(n)], count


@pytest.mark.parametrize("make", [lambda: kron(9), lambda: gap_uniform.edges(
    {"scale": 8, "degree": 2}, torch.Generator().manual_seed(SEED), torch.device("cpu"))],
    ids=["kronecker", "uniform"])
def test_depths_and_graph500_count_equal_brute_force(make):
    n, src, dst = make()
    ref = reference.Reference(src, dst, n)
    labels = ref.labels.numpy()
    # a root in each of a few components, the largest among them
    roots = np.unique(labels[src.numpy()], return_index=True)[1][:4]
    for root in src.numpy()[roots]:
        want, count = brute(n, src, dst, int(root))
        assert ref.depths(int(root)).tolist() == want
        assert int(ref.tuples_in([root])[0]) == count


def test_graph500_kronecker_keeps_self_loops_and_repeats():
    n, src, dst = kron(10)
    assert src.numel() == 8 * n and int(src.max()) < n and int(dst.min()) >= 0
    assert int((src == dst).sum()) > 0
    keys = (src << 32) | dst
    assert torch.unique(keys).numel() < keys.numel()


@pytest.mark.parametrize("cell", CELLS)
def test_port_depths_equal_the_reference_and_the_control_fails(small_root, cell):
    run = harness.run_cell(small_root, cell, SEED, 0.05, False, "cpu", control=True)
    sampled = min(int(run.cell.traffic["sample_units"]), len(run.units))
    assert run.correct and run.compared == sampled * run.units[0].size
    assert run.checks["mismatched_depths"] == (0, 0)
    assert run.control > 0
    assert run.counts["tuples"].sum() > 0 and run.window_s > 0


def test_control_fails_on_the_card(tmp_path, card):
    root = small_copy(tmp_path, scale=12)
    for cell in CELLS:
        run = harness.run_cell(root, cell, SEED, 0.05, False, card, control=True)
        assert run.correct and run.control > 0
