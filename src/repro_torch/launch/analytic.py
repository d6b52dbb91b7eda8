"""Analytic HBM-traffic model of one step (the roofline's memory term).

The port of ``repro.launch.analytic``: the bytes a train, prefill or
decode step must move, from exact sizes of the config, where a compiler's
own byte count would count fused intermediates at face value.  Built on
the port's :func:`repro_torch.models.api.param_counts`.

Model (global bytes per step, divided by chips):

  train:   read params + write grads + read+write optimizer moments
           + write params + activation stream: per layer, the saved
           residual (B·L·d, bf16) is written in fwd and re-read in bwd,
           and the remat recompute re-reads the layer params once more;
           plus the attention KV / score traffic and the logits chunk.
  prefill: read params + write KV cache + activation stream (fwd only).
  decode:  read params + read whole KV cache + write one token slot
           (SSM: read+write the recurrent state instead).

All terms are exact sizes from the config, except the activation
stream's factor for the intermediate ops inside a block.  The model holds
no hardware constant: a byte count over the H100's HBM rate
(:data:`repro_torch.launch.hlo_stats.HBM_BW`) gives the memory term's
time.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api

_BF16 = 2
_F32 = 4


def _param_bytes(cfg: ModelConfig) -> float:
    n = api.param_counts(cfg)["total"]
    return float(n) * (_BF16 if cfg.param_dtype == "bfloat16" else _F32)


def _active_param_bytes(cfg: ModelConfig) -> float:
    """Bytes of params actually TOUCHED per step (MoE: top-k experts only
    for compute, but the optimizer still touches all — handled by caller)."""
    counts = api.param_counts(cfg)
    n = counts["active"] + counts["embed"]
    return float(n) * (_BF16 if cfg.param_dtype == "bfloat16" else _F32)


def _opt_state_bytes(cfg: ModelConfig) -> float:
    n = api.param_counts(cfg)["total"]
    if cfg.optimizer == "adafactor":
        return float(n) * 0.02 * _F32  # factored: ~ (rows+cols)/(rows*cols)
    return float(n) * 2 * _F32  # adam m + v


def _kv_cache_bytes(cfg: ModelConfig, batch: int, s: int) -> float:
    if cfg.family == "ssm":
        state = cfg.n_layers * batch * (
            cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * _F32
            + (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * _BF16
        )
        return float(state)
    per_entry = cfg.n_kv_heads * cfg.resolved_head_dim * 2 * _BF16
    kv = 0.0
    for i in range(cfg.n_layers):
        if not cfg.is_attn_layer(i):
            continue
        s_i = s
        if cfg.ring_local_cache and not cfg.is_global_attn_layer(i):
            s_i = min(s, cfg.local_window)  # ring local cache
        kv += batch * s_i * per_entry
    if cfg.family == "hybrid":
        n_mamba = sum(1 for i in range(cfg.n_layers) if not cfg.is_attn_layer(i))
        kv += n_mamba * batch * (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * _F32)
    if cfg.family == "audio":
        kv += cfg.n_layers * batch * cfg.n_frames * cfg.n_kv_heads \
            * cfg.resolved_head_dim * 2 * _BF16
    return float(kv)


def _act_stream_bytes(cfg: ModelConfig, batch: int, l: int, train: bool) -> float:
    d = cfg.d_model
    per_layer = batch * l * d * _BF16
    layers_total = cfg.n_layers + cfg.encoder_layers
    # write residual fwd (+ read in bwd) + ~2 intermediate r/w inside block
    mult = (2 + 4) if train else 3
    return float(layers_total) * per_layer * mult


def step_bytes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """``{"global": bytes a step moves, "detail": {"params", "active"}}``."""
    b, l = shape.global_batch, shape.seq_len
    p = _param_bytes(cfg)
    pa = _active_param_bytes(cfg)
    if shape.kind == "train":
        opt = _opt_state_bytes(cfg)
        total = (
            pa  # fwd reads active params
            + pa  # remat recompute reads them again in bwd
            + p  # grads written (all params get grads)
            + p  # params written
            + 2 * opt  # moments read + write
            + _act_stream_bytes(cfg, b, l, train=True)
        )
    elif shape.kind == "prefill":
        total = pa + _kv_cache_bytes(cfg, b, l) + _act_stream_bytes(cfg, b, l, False)
    else:  # decode
        extra = cfg.n_patches if cfg.family == "vlm" else 0
        total = pa + _kv_cache_bytes(cfg, b, l + extra) + b * cfg.d_model * 400
    return {"global": total, "detail": {"params": p, "active": pa}}
