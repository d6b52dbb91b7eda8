"""Shared helpers of the port's roofline-term parity tests
(``test_torch_hlo_flops_*.py``): one step of a reduced config counted on
both sides.  The reference compiles the step from ``ShapeDtypeStruct``
stand-ins and counts ``hlo_stats.dot_flops`` of the optimized HLO (plus
``corrections.prefill_corrections`` for prefill), as
``tests/test_dryrun_analysis.py`` does; the port runs the step under
``FakeTensorMode`` (nothing allocated) inside ``FlopCounterMode``
(``launch.hlo_stats.count_flops``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import corrections as ref_corrections
from repro.launch import hlo_stats as ref_hlo
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_stats
from repro_torch.models import api

# the probe cells: batch 2, 64 tokens
BATCH, SEQ = 2, 64
# the archs with SSD layers
SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


def cfgs(arch: str):
    """The reduced config of ``arch`` in both packages, the reference's in its
    analysis mode (every scan unrolled, so the HLO holds every matmul)."""
    ref = dataclasses.replace(ref_configs.reduced(ref_configs.get_config(arch)),
                              scan_unroll=True)
    return ref, configs.reduced(configs.get_config(arch))


def _structs(defs, dtype):
    return jax.tree.map(lambda pd: jax.ShapeDtypeStruct(pd.shape, pd.dtype or dtype), defs,
                        is_leaf=lambda x: hasattr(x, "logical"))


def ref_flops(arch: str, kind: str) -> float:
    cfg, _ = cfgs(arch)
    shape = RefShape("t", SEQ, BATCH, kind)
    params = _structs(ref_api.param_defs(cfg), cfg.param_dtype)
    ins = _structs(ref_api.input_defs(cfg, shape), cfg.compute_dtype)
    if kind == "train":
        fn, args = jax.value_and_grad(ref_api.train_loss_fn(cfg)), (params, ins)
    elif kind == "prefill":
        fn, args = ref_api.prefill_fn(cfg), (params, ins)
    else:
        cache = _structs(ref_api.cache_defs(cfg, shape), cfg.compute_dtype)
        fn = ref_api.decode_fn(cfg)
        args = (params, cache, ins["token"], jax.ShapeDtypeStruct((), jnp.int32))
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return ref_hlo.dot_flops(hlo) + ref_corrections.prefill_corrections(cfg, shape)["flops"]


def port_flops(arch: str, kind: str):
    """-> (total, by op) of the port's step under fake tensors."""
    _, cfg = cfgs(arch)
    shape = ShapeConfig("t", SEQ, BATCH, kind)
    with FakeTensorMode():
        model = api.build_model(cfg, torch.device("cpu"))
        ins = shd.tree_map(
            lambda pd: torch.zeros(pd.shape, dtype=shd.resolve_dtype(pd, cfg.compute_dtype)),
            api.input_defs(cfg, shape))
        if kind == "train":
            for p in model.parameters():
                p.requires_grad_(True)

            def fn():
                api.train_loss_fn(cfg)(model, ins).backward()
        elif kind == "prefill":
            def fn():
                return api.prefill_fn(cfg)(model, ins)
        else:
            cache = shd.tree_map(
                lambda pd: torch.zeros(pd.shape,
                                       dtype=shd.resolve_dtype(pd, cfg.compute_dtype)),
                api.cache_defs(cfg, shape))

            def fn():
                return api.decode_fn(cfg)(model, cache, ins["token"], SEQ - 1)
        _, total, by_op = hlo_stats.count_flops(fn)
    return total, by_op


def ssm_train_gap(arch: str) -> float:
    """The matrix products the reference's train step has and the port's
    does not, in each SSM layer's SSD scan: the reference writes the
    intra-chunk output and the chunk states as three-operand einsums
    (``bcij,bcijh,bcjhp->bcihp`` and ``bcjn,bcjh,bcjhp->bchpn``), so their
    gradients with respect to the middle operand contract ``h`` (to
    ``cb``'s gradient: ``2 B nc q^2 H`` flops) and ``p`` (to the chunk-end
    decay's: ``2 B L H P``) as dots; the port multiplies that operand in
    elementwise first (``cb[..., None] * decay``, ``dend[..., None] * xdt``),
    whose gradient is a multiply and a sum, which no flop count sees.
    Together ``2 B L H (P + q)`` a layer, ``q`` the SSD chunk."""
    _, cfg = cfgs(arch)
    from repro_torch.models.mamba2 import ssd_chunk

    q = ssd_chunk(cfg.ssm_chunk, SEQ)
    n_ssm = sum(1 for i in range(cfg.n_layers)
                if cfg.family == "ssm" or not cfg.is_attn_layer(i))
    return float(n_ssm * 2 * BATCH * SEQ * cfg.n_ssm_heads * (cfg.ssm_head_dim + q))
