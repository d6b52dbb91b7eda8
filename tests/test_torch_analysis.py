"""The port's first analysis tools against the JAX package's:
``graph.partition.synthetic_shapes`` (the shapes of a partition from ``(n,
m, P)``), ``launch.analytic.step_bytes`` (a step's HBM bytes) and
``launch.corrections.prefill_corrections`` (what a scan-body flop count
of the prefill misses) equal the reference for every config and shape it
covers; the reference's structural checks hold; and
``FlopCounterMode`` counts every query chunk of the port's prefill, so
its chunked count equals the one-chunk count and needs no correction."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro.launch import analytic as ref_analytic
from repro.launch import corrections as ref_corrections
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.graph import generators, partition
from repro_torch.launch import analytic, corrections
from repro_torch.models import api, layers

CELLS = [(a, s) for a in configs.ARCH_NAMES for s in SHAPES]


def test_arch_and_shape_lists_match_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_configs.base.SHAPES.items()}


# --- synthetic_shapes --------------------------------------------------------


@pytest.mark.parametrize("scale,ef,p", [(10, 8, 8), (12, 8, 8), (12, 16, 3), (20, 16, 4),
                                        (23, 8, 16), (26, 16, 512), (7, 1, 1)])
def test_synthetic_shapes_match_reference(scale, ef, p):
    n, m = 1 << scale, 2 * (1 << scale) * ef
    got = partition.synthetic_shapes(n, m, p)
    want = ref_part.synthetic_shapes(n, m, p)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.array_shapes() == want.array_shapes()
    kw = dict(lane_pad=64, slack=1.3, vskew=2.0)
    assert dataclasses.asdict(partition.synthetic_shapes(n + 5, m, p, **kw)) == \
        dataclasses.asdict(ref_part.synthetic_shapes(n + 5, m, p, **kw))


def test_synthetic_shapes_upper_bound_real_partition():
    """``tests/test_graph.py``'s check on the port's partition: the sizing
    upper-bounds a real partition of Kronecker scale 12 at P = 8, and its
    planes are the partition's."""
    g = generators.kronecker(12, 8, seed=2)
    pg = partition.partition_1d(g, 8)
    syn = partition.synthetic_shapes(1 << 12, 2 * (1 << 12) * 8, 8)
    assert syn.emax >= pg.emax and syn.vmax >= pg.vmax and syn.n_words >= pg.n_words
    assert set(syn.array_shapes()) == set(pg.arrays())
    for k, shape in syn.array_shapes().items():
        assert len(shape) == pg.arrays()[k].ndim and shape[0] == pg.p
    # the same graph through the reference's partition: the same sizes
    rpg = ref_part.partition_1d(ref_gen.kronecker(12, 8, seed=2), 8)
    assert (pg.emax, pg.vmax, pg.n_words) == (rpg.emax, rpg.vmax, rpg.n_words)


# --- step_bytes --------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_bytes_match_reference(arch, shape):
    got = analytic.step_bytes(configs.get_config(arch), SHAPES[shape])
    want = ref_analytic.step_bytes(ref_configs.get_config(arch), ref_configs.base.SHAPES[shape])
    assert got == want


def test_analytic_bytes_structure():
    """``tests/test_dryrun_analysis.py::test_analytic_bytes_structure``."""
    cfg = configs.get_config("deepseek-7b")
    b_train = analytic.step_bytes(cfg, SHAPES["train_4k"])["global"]
    b_pre = analytic.step_bytes(cfg, SHAPES["prefill_32k"])["global"]
    b_dec = analytic.step_bytes(cfg, SHAPES["decode_32k"])["global"]
    n = api.param_counts(cfg)["total"]
    assert b_train > 2 * 4 * n  # must cover optimizer moments r/w
    kv = 30 * 128 * 32768 * 32 * 128 * 2 * 2  # decode reads the KV cache
    assert b_dec > kv
    assert b_pre > 0


# --- prefill_corrections -----------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_prefill_corrections_match_reference(arch, shape):
    got = corrections.prefill_corrections(configs.get_config(arch), SHAPES[shape])
    want = ref_corrections.prefill_corrections(ref_configs.get_config(arch),
                                               ref_configs.base.SHAPES[shape])
    assert got == want


def test_corrections_zero_for_train_and_decode():
    cfg = configs.get_config("olmo-1b")
    assert corrections.prefill_corrections(cfg, SHAPES["train_4k"])["flops"] == 0
    assert corrections.prefill_corrections(cfg, SHAPES["decode_32k"])["flops"] == 0
    assert corrections.prefill_corrections(cfg, SHAPES["prefill_32k"])["flops"] > 0


def test_corrections_windowed_smaller_than_global():
    g3, ds = configs.get_config("gemma3-27b"), configs.get_config("deepseek-7b")
    c_g3 = corrections.prefill_corrections(g3, SHAPES["prefill_32k"])["flops"]
    c_ds = corrections.prefill_corrections(ds, SHAPES["prefill_32k"])["flops"]
    # per layer: gemma's 5 of 6 local layers only pay window + chunk keys
    assert c_g3 / g3.n_layers < 0.35 * c_ds / ds.n_layers


def _long_cfg(mod):
    return dataclasses.replace(
        mod.reduced(mod.get_config("olmo-1b")),
        n_layers=2, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
        head_dim=32, vocab=256, scan_unroll=True,
    )


def test_flop_counter_counts_every_prefill_chunk(monkeypatch):
    """The meaning of the reference's monkeypatched ground truth, for the
    port: at 16 K tokens (16 chunks, past the unroll threshold) the port's
    chunked prefill counts as many flops as a one-chunk prefill, so it
    needs no correction, and the correction (equal to the reference's) is
    15 of the 16 chunks' attention matmuls: what a scan-body count misses.
    The model runs on the meta device: shapes only, no memory."""
    cfg = _long_cfg(configs)
    l = 16 * 1024
    model = api.build_model(cfg, torch.device("meta"))
    toks = torch.zeros((1, l), dtype=torch.int32, device="meta")
    prefill = api.prefill_fn(cfg)

    def count():
        with FlopCounterMode(display=False) as fc:
            prefill(model, {"tokens": toks})
        return fc.get_total_flops(), dict(fc.get_flop_counts()["Global"])

    assert layers.attn_chunking(cfg, l)[1] == 16
    chunked = count()
    monkeypatch.setattr(layers, "attn_chunking", lambda c, ll, causal=True: (ll, 1, 1))
    one_chunk = count()
    monkeypatch.undo()
    assert chunked == one_chunk
    shape = ShapeConfig("test_prefill", l, 1, "prefill")
    corr = corrections.prefill_corrections(cfg, shape)["flops"]
    assert corr == ref_corrections.prefill_corrections(_long_cfg(ref_configs), shape)["flops"]
    attention = cfg.n_layers * 4 * cfg.n_heads * l * l * cfg.resolved_head_dim
    assert corr == attention * 15 / 16
    assert chunked[1][torch.ops.aten.bmm] >= attention
