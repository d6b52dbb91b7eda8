"""Batched serving: prefill + decode loop with a static KV cache.

The port of ``repro.serve.engine``. The cache is grown to ``max_len`` once
after prefill (no allocation in the decode loop); prefill writes
``[0, prompt)``, each decode step writes one position in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api, layers, lm


def pad_cache(cache, max_len: int, _path=()):
    """Grow the SELF-attention KV seq axis (rank-5: L,B,S,H,D) to max_len.

    Path-aware: SSM states and whisper's cross-attention KV must NOT be
    padded (cross attention is unmasked: zero keys would perturb the
    softmax; SSM caches are recurrent state, not sequences)."""
    if isinstance(cache, dict):
        return {k: pad_cache(v, max_len, _path + (k,)) for k, v in cache.items()}
    x = cache
    if "mamba" in _path or "cross" in _path:
        return x
    # KV layout is (..., S, Hk, D): seq axis is always ndim-3
    # (rank 5 for flat layer stacks, rank 6 for period groups).
    ax = x.ndim - 3
    if _path[-1] in ("k", "v") and x.ndim >= 5 and x.shape[ax] < max_len:
        pad = [0, 0] * (x.ndim - ax - 1) + [0, max_len - x.shape[ax]]
        return F.pad(x, pad)
    return x


def prepare_decode_cache(cfg: ModelConfig, cache, pos: int, max_len: int):
    """Pad prefill caches for decode; under ``cfg.ring_local_cache``,
    convert sliding-window layers to the ring layout."""
    if not cfg.ring_local_cache or cfg.local_window == 0:
        return pad_cache(cache, max_len)
    w = cfg.local_window
    lpg = cfg.locals_per_global
    kinds = {g[0]: g[2] for g in lm.layer_groups(cfg)}
    out = {}
    for name, gc in cache.items():
        kind = kinds.get(name)
        if kind == "attn_period":
            li = [j for j in range(lpg + 1) if j != lpg]
            out[name] = {
                "local": {c: layers.to_ring(gc[c][:, li], pos, w) for c in ("k", "v")},
                "global": pad_cache({c: gc[c][:, lpg:lpg + 1] for c in ("k", "v")},
                                    max_len),
            }
        elif kind == "attn_local":
            out[name] = {c: layers.to_ring(gc[c], pos, w) for c in ("k", "v")}
        else:
            out[name] = pad_cache({"x": gc}, max_len)["x"]
    return out


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> token ids (B,). Greedy at temperature 0; otherwise
    a categorical draw (Gumbel-max, in float32) from ``generator``, over
    the ``top_k`` largest logits when ``top_k`` > 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray  # (B, n_new)
    steps: int


def generate(
    cfg: ModelConfig,
    model,
    prompts: torch.Tensor,  # (B, L_prompt) int
    n_new: int,
    *,
    extra_inputs: Optional[Dict] = None,  # frames / patches for audio / vlm
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    rules=None,
    mesh=None,
) -> GenerateResult:
    """Prefill the prompts then decode ``n_new`` tokens (greedy or sampled)
    on the model's device. With ``rules`` and a ``mesh`` that has a model
    axis the model must be sharded over it (``api.init_params(...,
    rules=, mesh=)``): it runs tensor-parallel, and each token comes from
    the full (all-gathered) logits. With FSDP rules the model must be
    built with them too: each pass gathers a unit's parameters before the
    unit runs."""
    dev = model.embed.tok.device
    b, lp = prompts.shape
    inputs = {k: v.to(dev) for k, v in {"tokens": prompts, **(extra_inputs or {})}.items()}
    prefill = api.prefill_fn(cfg, rules, mesh)
    decode = api.decode_fn(cfg, rules, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.inference_mode():
        logits, cache, pos = prefill(model, inputs)
        prefix = cfg.n_patches if cfg.family == "vlm" else 0
        cache = prepare_decode_cache(cfg, cache, lp + prefix, lp + prefix + n_new)
        tok = sample(logits, gen, temperature=temperature, top_k=top_k)
        out = [tok]
        for i in range(n_new - 1):
            logits, cache = decode(model, cache, tok[:, None], pos + i)
            tok = sample(logits, gen, temperature=temperature, top_k=top_k)
            out.append(tok)
        tokens = torch.stack(out, dim=1).cpu().numpy()
    return GenerateResult(tokens=tokens, steps=n_new)
