"""Whisper-style encoder-decoder backbone (audio frontend is a stub).

The port of ``repro.models.encdec``. Inputs are precomputed frame
embeddings (B, n_frames, d_model). The encoder is bidirectional; the
decoder has causal self-attention + cross-attention to the encoder output
and no embedding scale. Decode caches: per-layer self-attn KV (written in
place) + precomputed cross KV. With ``cfg.remat``, a pass that records
gradients checkpoints each encoder and decoder layer.

A model built with a :class:`~repro_torch.core.collectives.TensorParallel`
(``model.tp``) runs every pass over the model axis as ``lm``'s do: the
encoder's and decoder's attention by heads (bidirectional in the
encoder), the cross attention by heads (its cache replicated, as the
reference's spec leaves its kv heads), the MLPs by ``ff``, the tied
embedding by the vocabulary; the layernorms replicated.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import DTYPES, PD
from repro_torch.models import layers
from repro_torch.models.lm import (AttnBlock, _stack, chunked_xent, chunked_xent_tp,
                                   embed_tokens_tp, gathered, lm_logits, lm_logits_tp,
                                   pass_scope, unit)


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

    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg, device, tp)
        self.attn = layers.Attention(cfg, device, tp)
        self.lnx = layers.Norm(cfg, device, tp)
        self.xattn = layers.Attention(cfg, device, tp)
        self.ln2 = layers.Norm(cfg, device, tp)
        self.mlp = layers.MLP(cfg, device, tp=tp)

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

    def _rest_tp(self, y, heads, tp):
        cfg = self.cfg
        y = y + layers.cross_attention_tp(cfg, self.xattn, layers.apply_norm(cfg, self.lnx, y),
                                          heads, tp)
        return y + layers.mlp_tp(cfg, self.mlp, layers.apply_norm(cfg, self.ln2, y), tp)

    def forward_tp(self, x, enc, tp, want_cache: bool = False):
        """:meth:`forward` over the model axis: -> (x, the replicated
        ((k, v), cross (k, v)) when ``want_cache``, else None)."""
        cfg = self.cfg
        h, kv = layers.self_attention_tp(cfg, self.attn, layers.apply_norm(cfg, self.ln1, x),
                                         tp, want_kv=want_cache)
        heads, xkv = layers.cross_kv_tp(cfg, self.xattn, enc, tp, want_kv=want_cache)
        return self._rest_tp(x + h, heads, tp), ((kv, xkv) if want_cache else None)

    def decode_tp(self, x, ck, cv, xk, xv, pos: int, tp):
        """:meth:`decode` over the model axis (the caches replicated)."""
        cfg = self.cfg
        h = layers.decode_attention_tp(cfg, self.attn, layers.apply_norm(cfg, self.ln1, x),
                                       ck, cv, pos, tp)
        return self._rest_tp(x + h, layers.cross_heads_tp(cfg, self.xattn, xk, xv, tp), tp)


class EncDec(nn.Module):
    """``embed``, ``enc`` (encoder blocks), ``enc_norm``, ``groups.dec``,
    ``final_norm``; the head is tied to the embedding."""

    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.fsdp = None  # api.build_model sets it
        self.embed = layers.ParamModule(cfg, param_defs(cfg)["embed"], device, tp)
        self.enc = nn.ModuleList(AttnBlock(cfg, device, tp=tp)
                                 for _ in range(cfg.encoder_layers))
        self.enc_norm = layers.Norm(cfg, device, tp)
        self.groups = nn.ModuleDict({"dec": nn.ModuleList(
            DecBlock(cfg, device, tp) for _ in range(cfg.n_layers))})
        self.final_norm = layers.Norm(cfg, device, tp)


def decode_cache_defs(cfg: ModelConfig, batch: int, s: int, long_ctx=False) -> Dict:
    hk, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    seq_l = "long_seq" if long_ctx else "seq"

    def kv(length, sl):
        return {
            "k": PD((n, batch, length, hk, hd), ("layers", "batch", sl, None, None), "zeros"),
            "v": PD((n, batch, length, hk, hd), ("layers", "batch", sl, None, None), "zeros"),
        }

    return {"self": kv(s, seq_l), "cross": kv(cfg.n_frames, None)}


def _tp_of(model: EncDec, tp, batch: int):
    """``tp``, else the model's (None: unsharded), for a batch of ``batch`` rows."""
    tp = tp if tp is not None else getattr(model, "tp", None)
    return None if tp is None else tp.for_batch(batch)


def encode(cfg: ModelConfig, model: EncDec, frames: torch.Tensor, tp=None) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub embeddings -> encoder states
    (over the model axis for a sharded model, or with ``tp``)."""
    tp = _tp_of(model, tp, frames.shape[0])
    x = frames.to(DTYPES[cfg.compute_dtype])
    for blk in model.enc:
        if tp is None:
            x, _ = unit(cfg, model, blk, blk, x, None, False)
        else:
            x, _ = unit(cfg, model, blk, blk.forward_tp, x, tp, None, False, False)
    with gathered(model, model.enc_norm):
        return layers.apply_norm(cfg, model.enc_norm, x)


def _decoder(cfg, model: EncDec, tokens, enc, *, want_cache=False, tp=None):
    """-> (final hidden, ((k, v), (cross k, cross v)) stacked over layers, or None)."""
    tp = _tp_of(model, tp, tokens.shape[0])
    with gathered(model, model.embed):
        if tp is None:
            x = model.embed.tok[tokens.long()].to(DTYPES[cfg.compute_dtype])
        else:
            x = embed_tokens_tp(cfg, model, tokens, tp).to(DTYPES[cfg.compute_dtype])
    kvs, xkvs = [], []
    for blk in model.groups["dec"]:
        if tp is None:
            x, (kv, xkv) = unit(cfg, model, blk, blk, x, enc)
        else:
            x, c = unit(cfg, model, blk, blk.forward_tp, x, enc, tp, want_cache)
            kv, xkv = c if want_cache else (None, None)
        if want_cache:
            kvs.append(kv)
            xkvs.append(xkv)
    ys = None
    if want_cache:
        ys = tuple(tuple(torch.stack([c[i] for c in cs]) for i in (0, 1))
                   for cs in (kvs, xkvs))
    with gathered(model, model.final_norm):
        return layers.apply_norm(cfg, model.final_norm, x), ys


def train_loss(cfg: ModelConfig, model: EncDec, batch: Dict, *, tp=None) -> torch.Tensor:
    """The mean next-token cross-entropy; a sharded model's (or, with
    ``tp``, one data group's view's) vocab-parallel."""
    tp = _tp_of(model, tp, batch["tokens"].shape[0])
    with pass_scope(cfg, model):
        enc = encode(cfg, model, batch["frames"], tp)
        h, _ = _decoder(cfg, model, batch["tokens"], enc, tp=tp)
        if tp is not None:
            return chunked_xent_tp(cfg, model, h, batch["labels"], tp)
        return chunked_xent(cfg, model, h, batch["labels"],
                            rows=getattr(model, "fsdp", None))


def prefill(cfg: ModelConfig, model: EncDec, tokens, *, frames):
    with pass_scope(cfg, model):
        enc = encode(cfg, model, frames)
        h, ys = _decoder(cfg, model, tokens, enc, want_cache=True)
        (k, v), (xk, xv) = ys
        cache = {"self": {"k": k, "v": v}, "cross": {"k": xk, "v": xv}}
        tp = _tp_of(model, None, tokens.shape[0])
        if tp is not None:
            return lm_logits_tp(cfg, model, h[:, -1], tp), cache, tokens.shape[1]
        return lm_logits(cfg, model, h[:, -1]), cache, tokens.shape[1]


def decode_step(cfg: ModelConfig, model: EncDec, cache: Dict, token, pos: int):
    tp = _tp_of(model, None, token.shape[0])
    sc, xc = cache["self"], cache["cross"]
    with pass_scope(cfg, model):
        if tp is None:
            x = model.embed.tok[token.long()].to(DTYPES[cfg.compute_dtype])
            for i, blk in enumerate(model.groups["dec"]):
                x = unit(cfg, model, blk, blk.decode, x, sc["k"][i], sc["v"][i], xc["k"][i],
                         xc["v"][i], pos)
            with gathered(model, model.final_norm):
                x = layers.apply_norm(cfg, model.final_norm, x)
            return lm_logits(cfg, model, x[:, 0]), cache
        x = embed_tokens_tp(cfg, model, token, tp).to(DTYPES[cfg.compute_dtype])
        for i, blk in enumerate(model.groups["dec"]):
            x = unit(cfg, model, blk, blk.decode_tp, x, sc["k"][i], sc["v"][i], xc["k"][i],
                     xc["v"][i], pos, tp)
        with gathered(model, model.final_norm):
            x = layers.apply_norm(cfg, model.final_norm, x)
        return lm_logits_tp(cfg, model, x[:, 0], tp), cache
