"""Whisper-style encoder-decoder backbone (audio frontend is a stub).

The port of ``repro.models.encdec``. Inputs are precomputed frame
embeddings (B, n_frames, d_model). The encoder is bidirectional; the
decoder has causal self-attention + cross-attention to the encoder output
and no embedding scale. Decode caches: per-layer self-attn KV (written in
place) + precomputed cross KV. With ``cfg.remat``, a pass that records
gradients checkpoints each encoder and decoder layer.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import DTYPES, PD
from repro_torch.models import layers
from repro_torch.models.lm import AttnBlock, _stack, chunked_xent, lm_logits, remat


def _enc_block_defs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": layers.norm_defs(cfg),
        "attn": layers.attn_defs(cfg),
        "ln2": layers.norm_defs(cfg),
        "mlp": layers.mlp_defs(cfg),
    }


def _dec_block_defs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": layers.norm_defs(cfg),
        "attn": layers.attn_defs(cfg),
        "lnx": layers.norm_defs(cfg),
        "xattn": layers.attn_defs(cfg),
        "ln2": layers.norm_defs(cfg),
        "mlp": layers.mlp_defs(cfg),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "embed": {"tok": PD((cfg.padded_vocab, d), ("vocab", "embed"), "normal")},
        "enc": _stack(_enc_block_defs(cfg), cfg.encoder_layers),
        "enc_norm": layers.norm_defs(cfg),
        "groups": {"dec": _stack(_dec_block_defs(cfg), cfg.n_layers)},
        "final_norm": layers.norm_defs(cfg),
    }


class DecBlock(nn.Module):
    """Causal self-attention, cross-attention, MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg, device)
        self.attn = layers.Attention(cfg, device)
        self.lnx = layers.Norm(cfg, device)
        self.xattn = layers.Attention(cfg, device)
        self.ln2 = layers.Norm(cfg, device)
        self.mlp = layers.MLP(cfg, device)

    def _rest(self, y, xkv):
        cfg = self.cfg
        y = y + layers.cross_attention(cfg, self.xattn, layers.apply_norm(cfg, self.lnx, y),
                                       xkv)
        return y + layers.mlp(cfg, self.mlp, layers.apply_norm(cfg, self.ln2, y))

    def forward(self, x, enc):
        """-> (x, ((k, v), cross (k, v)))."""
        cfg = self.cfg
        h, kv = layers.self_attention(cfg, self.attn, layers.apply_norm(cfg, self.ln1, x))
        xkv = layers.cross_kv(cfg, self.xattn, enc)
        return self._rest(x + h, xkv), (kv, xkv)

    def decode(self, x, ck, cv, xk, xv, pos: int):
        cfg = self.cfg
        h, _, _ = layers.decode_attention(cfg, self.attn, layers.apply_norm(cfg, self.ln1, x),
                                          ck, cv, pos)
        return self._rest(x + h, (xk, xv))


class EncDec(nn.Module):
    """``embed``, ``enc`` (encoder blocks), ``enc_norm``, ``groups.dec``,
    ``final_norm``; the head is tied to the embedding."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = layers.ParamModule(cfg, param_defs(cfg)["embed"], device)
        self.enc = nn.ModuleList(AttnBlock(cfg, device) for _ in range(cfg.encoder_layers))
        self.enc_norm = layers.Norm(cfg, device)
        self.groups = nn.ModuleDict({"dec": nn.ModuleList(
            DecBlock(cfg, device) for _ in range(cfg.n_layers))})
        self.final_norm = layers.Norm(cfg, device)


def decode_cache_defs(cfg: ModelConfig, batch: int, s: int, long_ctx=False) -> Dict:
    hk, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    seq_l = "long_seq" if long_ctx else "seq"

    def kv(length, sl):
        return {
            "k": PD((n, batch, length, hk, hd), ("layers", "batch", sl, None, None), "zeros"),
            "v": PD((n, batch, length, hk, hd), ("layers", "batch", sl, None, None), "zeros"),
        }

    return {"self": kv(s, seq_l), "cross": kv(cfg.n_frames, None)}


def encode(cfg: ModelConfig, model: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub embeddings -> encoder states."""
    x = frames.to(DTYPES[cfg.compute_dtype])
    for blk in model.enc:
        x, _ = remat(cfg, blk, x, None, False)
    return layers.apply_norm(cfg, model.enc_norm, x)


def _decoder(cfg, model: EncDec, tokens, enc, *, want_cache=False):
    """-> (final hidden, ((k, v), (cross k, cross v)) stacked over layers, or None)."""
    x = model.embed.tok[tokens.long()].to(DTYPES[cfg.compute_dtype])
    kvs, xkvs = [], []
    for blk in model.groups["dec"]:
        x, (kv, xkv) = remat(cfg, blk, x, enc)
        if want_cache:
            kvs.append(kv)
            xkvs.append(xkv)
    ys = None
    if want_cache:
        ys = tuple(tuple(torch.stack([c[i] for c in cs]) for i in (0, 1))
                   for cs in (kvs, xkvs))
    return layers.apply_norm(cfg, model.final_norm, x), ys


def train_loss(cfg: ModelConfig, model: EncDec, batch: Dict) -> torch.Tensor:
    enc = encode(cfg, model, batch["frames"])
    h, _ = _decoder(cfg, model, batch["tokens"], enc)
    return chunked_xent(cfg, model, h, batch["labels"])


def prefill(cfg: ModelConfig, model: EncDec, tokens, *, frames):
    enc = encode(cfg, model, frames)
    h, ys = _decoder(cfg, model, tokens, enc, want_cache=True)
    (k, v), (xk, xv) = ys
    cache = {"self": {"k": k, "v": v}, "cross": {"k": xk, "v": xv}}
    return lm_logits(cfg, model, h[:, -1]), cache, tokens.shape[1]


def decode_step(cfg: ModelConfig, model: EncDec, cache: Dict, token, pos: int):
    x = model.embed.tok[token.long()].to(DTYPES[cfg.compute_dtype])
    sc, xc = cache["self"], cache["cross"]
    for i, blk in enumerate(model.groups["dec"]):
        x = blk.decode(x, sc["k"][i], sc["v"][i], xc["k"][i], xc["v"][i], pos)
    x = layers.apply_norm(cfg, model.final_norm, x)
    return lm_logits(cfg, model, x[:, 0]), cache
