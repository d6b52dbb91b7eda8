"""The port's roofline terms (``repro_torch.launch.hlo_stats``) against the
reference's HLO counts: the Communicator's record by collective kind
equals the reference's ``collective_stats`` of the same sync compiled on
``mesh8`` (the butterfly, all-to-all, the non-fallback sparse sync and
the psum's all-reduce), ``branch_stats`` equals
``conditional_branch_stats`` branch for branch, the fake-tensor memory
peak equals the real CPU one, and the five ported modules state no TPU
figure."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import collectives as ref_coll
from repro.launch import hlo_stats as ref_hlo
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import collectives, profiler
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_stats
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod

P8, W = 8, 4096


def _ref_stats(fn, w):
    mesh8 = jax.make_mesh((P8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    sm = jax.shard_map(fn, mesh=mesh8, in_specs=P("data"), out_specs=P("data"),
                       check_vma=False)
    txt = jax.jit(sm).lower(jax.ShapeDtypeStruct((P8, w), jnp.uint32)).compile().as_text()
    return txt


def _port_stats(fn, w, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**31, (P8, w), dtype=np.int64).astype(np.int32))
    comm = collectives.Communicator(P8, "cpu")
    fn(x, comm)
    return comm, hlo_stats.collective_stats(comm)


CASES = {
    # tests/test_hlo_stats.py::test_butterfly_vs_alltoall_wire_bytes
    "butterfly_or": (lambda v: ref_coll.butterfly_or(v, "data", fanout=1),
                     lambda x, c: collectives.butterfly_or(x, c, fanout=1), W),
    "all_to_all_merge": (lambda v: ref_coll.all_to_all_merge(v, "data", op="or"),
                         lambda x, c: collectives.all_to_all_merge(x, c, op="or"), W),
    # tests/test_sparse_frontier.py::test_sparse_byte_model_matches_hlo
    "sparse": (lambda v: ref_coll.butterfly_or_sparse(
                   v[0], "data", fanout=2, capacity=32, fallback=False)[None],
               lambda x, c: collectives.butterfly_or_sparse(
                   x, c, fanout=2, capacity=32, fallback=False), 1 << 12),
}


@pytest.mark.parametrize("name", list(CASES))
def test_collective_stats_match_reference(name):
    ref_fn, port_fn, w = CASES[name]
    want = ref_hlo.collective_stats(_ref_stats(ref_fn, w))
    comm, got = _port_stats(port_fn, w)
    assert got == want
    assert got["collective-permute"]["count"] > 0
    # every rank sends in these syncs: the wire bytes are a rank's count
    assert got["collective-permute"]["wire_bytes"] == comm.bytes_sent[0]
    assert (comm.bytes_sent == comm.bytes_sent[0]).all()


def test_butterfly_counts_as_in_hlo_tests():
    """``tests/test_hlo_stats.py:62``: 3 permutes of 16,384 B at width 4096."""
    _, st = _port_stats(CASES["butterfly_or"][1], W)
    assert st["collective-permute"] == {"count": 3, "operand_bytes": 3 * 16384.0,
                                        "wire_bytes": 3 * 16384.0}
    _, a2a = _port_stats(CASES["all_to_all_merge"][1], W)
    assert a2a["collective-permute"]["count"] == 7


def test_psum_is_one_all_reduce():
    """The reference's psum (``xla_allreduce``) is one all-reduce of one
    buffer in its HLO; the port's all-gather of shifts records itself so,
    its shifts not counted as permutes.  Its wire bytes are what the port
    sends, ``G - 1`` buffers (the reference estimates a ring's ``2 N (G -
    1) / G``)."""
    want = ref_hlo.collective_stats(_ref_stats(
        lambda v: ref_coll.xla_allreduce(v, "data"), W))
    comm, got = _port_stats(lambda x, c: collectives.xla_allreduce(x, c), W)
    for k in ("count", "operand_bytes"):
        assert got["all-reduce"][k] == want["all-reduce"][k]
    assert got["all-reduce"]["count"] == 1
    assert got["all-reduce"]["wire_bytes"] == (P8 - 1) * W * 4 == comm.bytes_sent[0]
    assert want["all-reduce"]["wire_bytes"] == 2 * W * 4 * (P8 - 1) / P8
    assert got["collective-permute"]["count"] == 0


def test_grad_sync_records_its_leaves():
    """``sync_leaf`` under ``xla_psum``: one all-reduce a leaf; under the
    butterfly: the rounds' permutes; the bytes a rank equal the byte
    model either way."""
    g = torch.ones((4, 10), dtype=torch.float32)
    for method, kind, count in (("xla_psum", "all-reduce", 1),
                                ("butterfly", "collective-permute", 2)):
        comm = collectives.Communicator(4, "cpu")
        collectives.sync_leaf(g, comm, method=method)
        st = hlo_stats.collective_stats(comm)
        assert st[kind]["count"] == count
        assert st[kind]["wire_bytes"] == comm.bytes_sent[0] == \
            collectives.grad_sync_bytes(method, 4, 2, 10, 4)


def test_branch_stats_match_reference():
    """``tests/test_sparse_frontier.py:139``: the adaptive sync at P = 8,
    ``nw = 1 << 14``, ``cap = max(64, nw // 100)``; branch 0 dense, branch 1
    sparse, each equal to the reference's branch kind for kind."""
    nw = 1 << 14
    cap = max(64, nw // 100)
    txt = _ref_stats(lambda v: ref_coll.butterfly_or_adaptive(
        v[0], "data", fanout=2, capacity=cap, density_threshold=0.01)[None], nw)
    want = ref_hlo.conditional_branch_stats(txt)
    got = hlo_stats.branch_stats(
        lambda x, c: collectives.butterfly_or_adaptive(x, c, fanout=2, capacity=cap,
                                                       density_threshold=0.01),
        hlo_stats.forcing_inputs(P8, nw, device="cpu"), P8)
    assert len(got) == len(want) == 1
    assert [name for name, _ in got[0]] == ["dense", "sparse"]
    assert [st for _, st in got[0]] == [st for _, st in want[0]]
    dense, sparse = (st["collective-permute"]["wire_bytes"] for _, st in got[0])
    assert sparse <= 0.10 * dense


def _train_args(cfg, shape):
    model = api.build_model(cfg, torch.device("cpu"))
    state = optim.get(cfg.optimizer).init(model)
    batch = shd.tree_map(
        lambda pd: torch.zeros(pd.shape, dtype=shd.resolve_dtype(pd, cfg.compute_dtype)),
        api.input_defs(cfg, shape))
    return model, state, batch


def test_fake_memory_equals_cpu():
    """The ``MemTracker`` peak of a reduced qwen3 train step under fake
    tensors equals the same step's on real CPU tensors, key for key."""
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    shape = ShapeConfig("t", 64, 2, "train")
    fn = step_mod.build_train_step(cfg)
    with FakeTensorMode():
        fake = hlo_stats.measure(fn, *_train_args(cfg, shape), 0)
    real = hlo_stats.measure(fn, *_train_args(cfg, shape), 0)
    assert fake.memory.pop("source") == "fake" and real.memory.pop("source") == "cpu"
    assert fake.memory == real.memory
    assert fake.flops == real.flops > 0 and fake.flops_by_op == real.flops_by_op
    m = fake.memory
    assert m["argument_size_in_bytes"] == hlo_stats.nbytes(_train_args(cfg, shape))
    assert m["peak_bytes_per_device"] == m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    assert m["temp_size_in_bytes"] > 0


def test_count_flops_matmul_fake_and_real():
    """``tests/test_hlo_stats.py::test_dot_flops_simple_matmul``."""
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    out, total, by_op = hlo_stats.count_flops(torch.matmul, a, b)
    assert total == 2 * 64 * 128 * 32 and by_op == {"aten.mm": total}
    assert out.shape == (64, 32)
    with FakeTensorMode():
        assert hlo_stats.count_flops(torch.matmul, torch.ones(64, 128),
                                     torch.ones(128, 32))[1] == total
    # no matrix product, no flops (the reference counts dots only)
    assert hlo_stats.count_flops(torch.add, a, a)[1] == 0


def test_roofline_terms_and_profiler():
    """``tests/test_hlo_stats.py::test_roofline_terms`` on the H100 constants;
    the profiler's roofline is the same builder's, key for key."""
    r = hlo_stats.roofline(2 * 1024**3, 3 * 1024**2 * 2, 0.0)
    assert r.t_compute == 2 * 1024**3 / 989e12 and r.t_memory == 3 * 1024**2 * 2 / 3.35e12
    assert r.dominant in ("compute", "memory", "collective")
    assert r.step_time == max(r.t_compute, r.t_memory, r.t_collective)
    got = profiler.roofline(1e6, 2e5)
    assert got == dict(hlo_stats.roofline(0.0, 1e6, 2e5).__dict__,
                       dominant=got["dominant"], step_time=got["step_time"])
    assert list(got) == ["flops_per_device", "bytes_per_device", "collective_operand_bytes",
                         "collective_wire_bytes", "t_compute", "t_memory", "t_collective",
                         "dominant", "step_time"]
    assert profiler.HBM_BYTES_PER_S is hlo_stats.HBM_BW
    assert profiler.NVLINK_BYTES_PER_S is hlo_stats.LINK_BW


PORTED = ("hlo_stats", "dryrun", "summary", "reroof", "fill_experiments")
# the reference's TPU v5e figures: its peak, HBM rate, link rate and memory
TPU_FIGURES = re.compile(r"\b197e12|\b819e9|\b50e9|16 \* 2\s*\*\*\s*30|16 ?GiB|v5e|V5E|ICI_BW")


@pytest.mark.parametrize("mod", PORTED)
def test_no_tpu_figure(mod):
    path = os.path.join(os.path.dirname(hlo_stats.__file__), f"{mod}.py")
    with open(path) as f:
        text = f.read()
    assert not TPU_FIGURES.findall(text), mod
