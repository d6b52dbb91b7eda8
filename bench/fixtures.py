"""Fixtures of the benchmark's tests, imported by each test module: a copy
of the benchmark whose graphs are cut to a scale the CPU runs in a blink,
one torch thread, and the card where there is one."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SMALL_SCALE = 10
#: The wave cell, kept out of ``BENCHMARK.json`` until its runs spread less
#: (its driver and mix are in place); the tests add it as a later cell would.
WAVE_CELL = {"name": "kron23.waves32", "config": "kron-s23-ef8", "traffic": "waves32",
             "chips": 1, "why": "32 searches a wave through BFSQueryEngine.query"}


def small_copy(dest: Path, scale: int = SMALL_SCALE) -> Path:
    """``dest`` made a checkout of the benchmark alone (``BENCHMARK.json``
    and ``bench/``), every configuration cut to ``scale``, with the wave
    cell added."""
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*", "fixtures.py"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["scale"] = scale
        (dest / c["file"]).write_text(json.dumps(cfg))
    spec["workloads"].append(WAVE_CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return small_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors run fastest on one thread, and the suite's workers share
    the cores; the setting is restored after each test."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
