"""Analytic prefill-attention corrections (the port of
``repro.launch.corrections``).

The JAX package counts a compiled program's flops, and its prefill
attention runs the query chunks in a scan whose body the count sees once:
``(n - 1)`` of ``n`` chunks go missing whenever ``n > 8``.
:func:`prefill_corrections` is that missing part, by the exact matmul
formula (scores + PV: ``4·B·Hq·C·Lk·hd`` flops a chunk; K and V re-read
a chunk), from :func:`repro_torch.models.layers.attn_chunking`, the plan
the model code runs.

**The port's flop counts need no correction.**  The port's prefill runs
its query chunks in a Python loop (``models.layers.self_attention``), so
``torch.utils.flop_counter.FlopCounterMode`` counts every chunk: the
chunked count equals the one-chunk count.  A flop count of the port must
never have :func:`prefill_corrections` added to it; the function stands
for comparing with the reference's counts, which do need it.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers


def _layer_correction(cfg: ModelConfig, b: int, l: int,
                      is_global: bool) -> Tuple[float, float]:
    q_chunk, n, unroll = layers.attn_chunking(cfg, l, causal=True)
    if n == 1 or unroll == n:  # every chunk counted
        return 0.0, 0.0
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lk = l if is_global else (cfg.local_window + q_chunk)
    flops_per_chunk = 4.0 * b * hq * q_chunk * lk * hd
    kv_bytes_per_chunk = 2.0 * b * lk * hk * hd * 2  # bf16 k + v
    return (n - 1) * flops_per_chunk, (n - 1) * kv_bytes_per_chunk


def prefill_corrections(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global (all-chips) flops/bytes a scan-body count of the prefill
    misses: ``{"flops", "bytes"}``, zero for train and decode shapes."""
    if shape.kind != "prefill":
        return {"flops": 0.0, "bytes": 0.0}
    b, l = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        # decoder self-attention layers (the encoder runs one chunk)
        f1, b1 = _layer_correction(cfg, b, l, is_global=True)
        return {"flops": cfg.n_layers * f1, "bytes": cfg.n_layers * b1}
    flops = byts = 0.0
    for i in range(cfg.n_layers):
        if not cfg.is_attn_layer(i):
            continue
        f1, b1 = _layer_correction(cfg, b, l, cfg.is_global_attn_layer(i))
        flops += f1
        byts += b1
    return {"flops": flops, "bytes": byts}
