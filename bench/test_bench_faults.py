"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have (unbroken, it comes out true: ``test_bench_reference.py``)."""

import numpy as np
import pytest

from bench import harness
from bench.fixtures import one_thread, small_root  # noqa: F401

SEED = 2**31 + 23


def unchanged(monkeypatch):
    """The level loop returns its state unchanged: no level is stepped."""
    from repro_torch.core import loop

    monkeypatch.setattr(loop, "host_while", lambda cond, step, state, **kw: state)


def half_the_ranks(monkeypatch):
    """Phase 1 of the upper half of the ranks left out."""
    from repro_torch.analytics import msbfs
    from repro_torch.core import bfs

    def drop(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            out[out.shape[0] // 2:] = 0
            return out
        return call

    for mod in (bfs, msbfs):
        monkeypatch.setattr(mod, "_expand_push", drop(bfs._expand_push))
        monkeypatch.setattr(mod, "_expand_pull", drop(bfs._expand_pull))


def half_the_lanes(monkeypatch):
    """The upper half of each wave's searches left out."""
    from repro_torch.analytics import msbfs

    build = msbfs.build_msbfs_fn

    def patched(*args, **kwargs):
        run = build(*args, **kwargs)

        def half(arrays, roots, *rest, **kw):
            roots = np.array(roots)
            roots[roots.size // 2:] = -1
            return run(arrays, roots, *rest, **kw)
        return half

    monkeypatch.setattr(msbfs, "build_msbfs_fn", patched)


def no_exchange(monkeypatch):
    """Phase 2 left out: each rank keeps its own bitmap."""
    from repro_torch.analytics import msbfs
    from repro_torch.core import bfs

    for mod in (bfs, msbfs):
        monkeypatch.setattr(mod, "_sync_frontier", lambda words, *a, **k: words)


def altered_answer(monkeypatch):
    """One reached vertex's depth changed where the search produces it."""
    from repro_torch.analytics import msbfs
    from repro_torch.core import bfs

    def alter(mod, name):
        build = getattr(mod, name)

        def patched(*args, **kwargs):
            run = build(*args, **kwargs)

            def altered(*a, **k):
                out = run(*a, **k)
                d = out[0]
                flat = d.reshape(-1)
                i = int(((flat > 0) & (flat < 2**31 - 1)).nonzero()[0, 0])
                flat[i] += 1
                return out
            return altered
        monkeypatch.setattr(mod, name, patched)

    alter(bfs, "build_bfs_fn")
    alter(msbfs, "build_msbfs_fn")


FAULTS = {"kron23.bfs": (unchanged, half_the_ranks, no_exchange, altered_answer),
          "kron23.waves32": (unchanged, half_the_lanes, no_exchange, altered_answer)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    run = harness.run_cell(small_root, cell, SEED, 0.02, False, "cpu")
    line = harness.result(run)
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert line["checks"]["mismatched_depths"]["value"] > 0
