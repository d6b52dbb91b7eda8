"""Decoder-only LM stack: dense / MoE / SSM / hybrid / VLM families.

The port of ``repro.models.lm``. The reference stacks each homogeneous
group of layers on a leading axis and scans it; here each group is a
``ModuleList`` in ``layer_groups`` order, run by a Python loop:

  dense / vlm : [("blocks", L)] or gemma3's [("periods", L/6), ("tail", r)]
  moe         : [("dense_blocks", k), ("moe_blocks", L-k)]   (kimi: k=1)
  ssm         : [("blocks", L)]                  mamba mixers, no MLP
  hybrid      : [("periods", L/period)]          jamba: attn at
                attn_offset, mamba elsewhere, MoE on odd sublayers

A parameter's name is the reference's path with the stacked axes as
``ModuleList`` indices (``groups.blocks.3.attn.wq`` is the reference's
``groups/blocks/attn/wq[3]``), which is how ``api.from_reference`` carries
weights across. The decode cache keeps the reference's layout (stacked
``[n, B, S, Hk, D]`` per group; ``state``/``conv_*`` dicts for SSMs) and
decode writes into it in place, so ``decode_inplace`` changes no result.

Three entry points share the per-layer bodies: ``forward_hidden`` (train),
``prefill`` (returns the KV/SSM cache), ``decode_step`` (one token). With
``cfg.remat``, a pass that records gradients checkpoints each layer (each
period of a periodic group) as the reference's ``jax.checkpoint`` does.

A model built with a :class:`~repro_torch.core.collectives.TensorParallel`
(``model.tp``; every family) runs every pass tensor-parallel over the
model axis (the section at the end): heads, kv heads, ff, experts,
``d_inner`` and the vocabulary split as the reference's rules split them;
:func:`tp_calls` is the byte model of its collectives.

A model built with a :class:`~repro_torch.core.collectives.FullyShardedData`
(``model.fsdp``, FSDP rules) holds each leaf with an ``embed`` dimension as
its data ranks' blocks. Every pass, plain or tensor-parallel, runs each
unit (one layer, one period: remat's unit, the reference's scan body)
through :func:`unit`, which gathers the unit's parameters just before it
runs and lets them go after (:func:`gathered`); remat's recompute gathers
again, and the backward reduce-scatters each gradient once. The
embedding, the final norm and the head are gathered where they are used,
a tied table once a pass (:func:`pass_scope`). :func:`fsdp_calls` is the
byte model of those collectives.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import DTYPES, PD, sorted_leaves, tree_map
from repro_torch.models import layers, mamba2, moe as moe_mod


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _stack(defs, n: int):
    """Add a leading stacked-layer axis to every PD in a def tree."""
    return tree_map(lambda pd: PD((n,) + pd.shape, ("layers",) + pd.logical, pd.init,
                                  pd.dtype), defs)


def _attn_block_defs(cfg: ModelConfig, use_moe: bool) -> Dict:
    d = {
        "ln1": layers.norm_defs(cfg),
        "attn": layers.attn_defs(cfg),
        "ln2": layers.norm_defs(cfg),
    }
    d["moe" if use_moe else "mlp"] = (
        moe_mod.moe_defs(cfg) if use_moe else layers.mlp_defs(cfg)
    )
    return d


def _ssm_block_defs(cfg: ModelConfig) -> Dict:
    return {"ln1": layers.norm_defs(cfg), "ssm": mamba2.ssm_defs(cfg)}


def _jamba_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(mamba, dense-MLP, MoE) sublayers of one jamba period."""
    per = cfg.attn_period
    n_moe = sum(1 for j in range(per) if cfg.is_moe_layer(j))
    return per - 1, per - n_moe, n_moe


def _jamba_period_defs(cfg: ModelConfig) -> Dict:
    n_mamba, n_dense, n_moe = _jamba_counts(cfg)
    return {
        "attn": {"ln": layers.norm_defs(cfg), "p": layers.attn_defs(cfg)},
        "mamba": _stack({"ln": layers.norm_defs(cfg), "p": mamba2.ssm_defs(cfg)}, n_mamba),
        "mlp": _stack({"ln": layers.norm_defs(cfg), "p": layers.mlp_defs(cfg)}, n_dense),
        "moe": _stack({"ln": layers.norm_defs(cfg), "p": moe_mod.moe_defs(cfg)}, n_moe),
    }


def layer_groups(cfg: ModelConfig) -> List[Tuple[str, int, str]]:
    """(group name, stack length, kind) in execution order.

    Sliding-window architectures (gemma3) run PERIODS of
    ``locals_per_global + 1`` layers so each in-period position has a
    fixed window (local layers take the sliced attention path; the global
    layer takes the full path)."""
    if cfg.family in ("dense", "vlm"):
        if cfg.locals_per_global:
            per = cfg.locals_per_global + 1
            full, rem = divmod(cfg.n_layers, per)
            g: List[Tuple[str, int, str]] = [("periods", full, "attn_period")]
            if rem:  # trailing layers continue the pattern (all local)
                g.append(("tail", rem, "attn_local"))
            return g
        return [("blocks", cfg.n_layers, "attn")]
    if cfg.family == "moe":
        g = []
        if cfg.first_dense_layers:
            g.append(("dense_blocks", cfg.first_dense_layers, "attn"))
        g.append(("moe_blocks", cfg.n_layers - cfg.first_dense_layers, "attn_moe"))
        return g
    if cfg.family == "ssm":
        return [("blocks", cfg.n_layers, "ssm")]
    if cfg.family == "hybrid":
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a whole "
                             f"number of {cfg.attn_period}-layer periods")
        return [("periods", cfg.n_layers // cfg.attn_period, "jamba")]
    raise ValueError(cfg.family)


_GROUP_DEFS = {
    "attn": lambda cfg: _attn_block_defs(cfg, use_moe=False),
    "attn_local": lambda cfg: _attn_block_defs(cfg, use_moe=False),
    "attn_moe": lambda cfg: _attn_block_defs(cfg, use_moe=True),
    "attn_period": lambda cfg: _stack(
        _attn_block_defs(cfg, use_moe=False), cfg.locals_per_global + 1
    ),
    "ssm": _ssm_block_defs,
    "jamba": _jamba_period_defs,
}


def _period_window(cfg: ModelConfig, j: int) -> Optional[int]:
    """Window for in-period position j (LLLLLG: global last)."""
    return None if j == cfg.locals_per_global else cfg.local_window


def param_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": {"tok": PD((cfg.padded_vocab, d), ("vocab", "embed"), "normal")},
        "final_norm": layers.norm_defs(cfg),
    }
    if cfg.family == "vlm":
        tree["embed"]["vit_proj"] = PD((cfg.patch_dim, d), (None, "embed"), "scaled")
    if not cfg.tie_embeddings:
        tree["head"] = PD((d, cfg.padded_vocab), ("embed", "vocab"), "scaled")
    tree["groups"] = {
        name: _stack(_GROUP_DEFS[kind](cfg), n) for name, n, kind in layer_groups(cfg)
    }
    return tree


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP (or MoE) block."""

    def __init__(self, cfg: ModelConfig, device, use_moe: bool = False, tp=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg, device, tp)
        self.attn = layers.Attention(cfg, device, tp)
        self.ln2 = layers.Norm(cfg, device, tp)
        if use_moe:
            self.moe = moe_mod.MoE(cfg, device, tp)
        else:
            self.mlp = layers.MLP(cfg, device, tp=tp)

    def _ffn(self, x):
        cfg = self.cfg
        if hasattr(self, "moe"):
            return x + moe_mod.moe_block(cfg, self.moe, layers.apply_norm(cfg, self.ln2, x))
        return x + layers.mlp(cfg, self.mlp, layers.apply_norm(cfg, self.ln2, x))

    def forward(self, x, window: Optional[int] = None, causal: bool = True):
        """-> (x, (k, v))."""
        h, kv = layers.self_attention(self.cfg, self.attn,
                                      layers.apply_norm(self.cfg, self.ln1, x),
                                      window=window, causal=causal)
        return self._ffn(x + h), kv

    def decode(self, x, ck, cv, pos: int, window: Optional[int] = None,
               ring: bool = False):
        """One token against the layer's cache (written in place)."""
        ln = layers.apply_norm(self.cfg, self.ln1, x)
        if ring:
            h, ck, cv = layers.decode_attention_ring(self.cfg, self.attn, ln, ck, cv, pos)
        else:
            h, ck, cv = layers.decode_attention(self.cfg, self.attn, ln, ck, cv, pos,
                                                window=window)
        return self._ffn(x + h), ck, cv

    def _ffn_tp(self, x, tp):
        cfg = self.cfg
        ln = layers.apply_norm(cfg, self.ln2, x)
        if hasattr(self, "moe"):
            return x + moe_mod.moe_block_tp(cfg, self.moe, ln, tp)
        return x + layers.mlp_tp(cfg, self.mlp, ln, tp)

    def forward_tp(self, x, tp, window: Optional[int] = None, want_kv: bool = False,
                   causal: bool = True):
        """:meth:`forward` over the model axis (``tp``): -> (x, the
        replicated (k, v) when ``want_kv``, else None)."""
        h, kv = layers.self_attention_tp(self.cfg, self.attn,
                                         layers.apply_norm(self.cfg, self.ln1, x), tp,
                                         window=window, causal=causal, want_kv=want_kv)
        return self._ffn_tp(x + h, tp), kv

    def decode_tp(self, x, ck, cv, pos: int, tp, window: Optional[int] = None,
                  ring: bool = False):
        """:meth:`decode` over the model axis."""
        ln = layers.apply_norm(self.cfg, self.ln1, x)
        h = layers.decode_attention_tp(self.cfg, self.attn, ln, ck, cv, pos, tp,
                                       window=window, ring=ring)
        return self._ffn_tp(x + h, tp)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg, device, tp)
        self.ssm = mamba2.SSM(cfg, device, tp)

    def forward(self, x, want_cache: bool = False):
        h, cache = mamba2.ssm_block(self.cfg, self.ssm,
                                    layers.apply_norm(self.cfg, self.ln1, x),
                                    want_cache=want_cache)
        return x + h, cache

    def decode(self, x, st: Dict):
        ln = layers.apply_norm(self.cfg, self.ln1, x)
        h, st = mamba2.ssm_decode_step(self.cfg, self.ssm, ln, st)
        return x + h, st

    def forward_tp(self, x, tp, want_cache: bool = False):
        """:meth:`forward` over the model axis."""
        h, cache = mamba2.ssm_block_tp(self.cfg, self.ssm,
                                       layers.apply_norm(self.cfg, self.ln1, x), tp,
                                       want_cache=want_cache)
        return x + h, cache

    def decode_tp(self, x, st: Dict, tp):
        """:meth:`decode` over the model axis."""
        ln = layers.apply_norm(self.cfg, self.ln1, x)
        h, st = mamba2.ssm_decode_step_tp(self.cfg, self.ssm, ln, st, tp)
        return x + h, st


class Sub(nn.Module):
    """One jamba sublayer: a norm ``ln`` and its mixer or MLP ``p``."""

    def __init__(self, cfg: ModelConfig, device, p: nn.Module, tp=None):
        super().__init__()
        self.ln = layers.Norm(cfg, device, tp)
        self.p = p


class JambaPeriod(nn.Module):
    """attn at ``attn_offset``, mamba elsewhere; MoE on the MoE sublayers."""

    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__()
        self.cfg = cfg
        n_mamba, n_dense, n_moe = _jamba_counts(cfg)
        self.attn = Sub(cfg, device, layers.Attention(cfg, device, tp), tp)
        self.mamba = nn.ModuleList(Sub(cfg, device, mamba2.SSM(cfg, device, tp), tp)
                                   for _ in range(n_mamba))
        self.mlp = nn.ModuleList(Sub(cfg, device, layers.MLP(cfg, device, tp=tp), tp)
                                 for _ in range(n_dense))
        self.moe = nn.ModuleList(Sub(cfg, device, moe_mod.MoE(cfg, device, tp), tp)
                                 for _ in range(n_moe))

    def _run(self, x, mixer, tp=None):
        """The period's sublayers; ``mixer(j, sub, ln_x)`` runs mixer j; the
        FFNs over the model axis with ``tp``."""
        cfg = self.cfg
        jm = jd = jmo = 0
        for j in range(cfg.attn_period):
            if j == cfg.attn_offset:
                sub = self.attn
            else:
                sub = self.mamba[jm]
                jm += 1
            x = x + mixer(j, sub, layers.apply_norm(cfg, sub.ln, x))
            if cfg.is_moe_layer(j):
                sp = self.moe[jmo]
                ln = layers.apply_norm(cfg, sp.ln, x)
                x = x + (moe_mod.moe_block(cfg, sp.p, ln) if tp is None
                         else moe_mod.moe_block_tp(cfg, sp.p, ln, tp))
                jmo += 1
            else:
                sp = self.mlp[jd]
                ln = layers.apply_norm(cfg, sp.ln, x)
                x = x + (layers.mlp(cfg, sp.p, ln) if tp is None
                         else layers.mlp_tp(cfg, sp.p, ln, tp))
                jd += 1
        return x

    def forward(self, x, want_cache: bool = False):
        """-> (x, (kv, stacked mamba states)) or (x, None)."""
        cfg = self.cfg
        kv, states = [None], []

        def mixer(j, sub, ln):
            if j == cfg.attn_offset:
                h, kv[0] = layers.self_attention(cfg, sub.p, ln, window=None)
                return h
            h, s = mamba2.ssm_block(cfg, sub.p, ln, want_cache=want_cache)
            states.append(s)
            return h

        x = self._run(x, mixer)
        if want_cache:
            return x, (kv[0], {k: torch.stack([s[k] for s in states]) for k in states[0]})
        return x, None

    def decode(self, x, ck, cv, cm: Dict, pos: int):
        """cm: this period's mamba states, stacked ``[per-1, ...]`` (in place)."""
        cfg = self.cfg
        jm = [0]

        def mixer(j, sub, ln):
            if j == cfg.attn_offset:
                h, _, _ = layers.decode_attention(cfg, sub.p, ln, ck, cv, pos)
                return h
            i = jm[0]
            h, st = mamba2.ssm_decode_step(cfg, sub.p, ln, {k: v[i] for k, v in cm.items()})
            for k, v in st.items():
                cm[k][i] = v
            jm[0] += 1
            return h

        return self._run(x, mixer)

    def forward_tp(self, x, tp, want_cache: bool = False):
        """:meth:`forward` over the model axis: the attention's cache
        replicated, the mamba states' split leaves as held blocks."""
        cfg = self.cfg
        kv, states = [None], []

        def mixer(j, sub, ln):
            if j == cfg.attn_offset:
                h, kv[0] = layers.self_attention_tp(cfg, sub.p, ln, tp, want_kv=want_cache)
                return h
            h, s = mamba2.ssm_block_tp(cfg, sub.p, ln, tp, want_cache=want_cache)
            states.append(s)
            return h

        x = self._run(x, mixer, tp)
        if want_cache:
            return x, (kv[0], {k: torch.stack([s[k] for s in states]) for k in states[0]})
        return x, None

    def decode_tp(self, x, ck, cv, cm: Dict, pos: int, tp):
        """:meth:`decode` over the model axis."""
        cfg = self.cfg
        jm = [0]

        def mixer(j, sub, ln):
            if j == cfg.attn_offset:
                return layers.decode_attention_tp(cfg, sub.p, ln, ck, cv, pos, tp)
            i = jm[0]
            h, st = mamba2.ssm_decode_step_tp(cfg, sub.p, ln,
                                              {k: v[i] for k, v in cm.items()}, tp)
            for k, v in st.items():
                cm[k][i] = v
            jm[0] += 1
            return h

        return self._run(x, mixer, tp)


def _group_module(cfg: ModelConfig, kind: str, device, tp=None) -> nn.Module:
    if kind in ("attn", "attn_local"):
        return AttnBlock(cfg, device, tp=tp)
    if kind == "attn_moe":
        return AttnBlock(cfg, device, use_moe=True, tp=tp)
    if kind == "attn_period":
        return nn.ModuleList(AttnBlock(cfg, device, tp=tp)
                             for _ in range(cfg.locals_per_global + 1))
    if kind == "ssm":
        return SSMBlock(cfg, device, tp)
    if kind == "jamba":
        return JambaPeriod(cfg, device, tp)
    raise ValueError(kind)


class LM(nn.Module):
    """The decoder-only model: ``embed``, ``groups`` (a ``ModuleDict`` of
    ``ModuleList``s in ``layer_groups`` order), ``final_norm``, ``head``.

    ``tp`` (a :class:`~repro_torch.core.collectives.TensorParallel`) builds
    it sharded over the model axis: each leaf the spec splits holds its
    blocks (``layers.tp_param``), and the passes run tensor-parallel."""

    def __init__(self, cfg: ModelConfig, device, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.fsdp = None  # api.build_model sets it
        defs = param_defs(cfg)
        self.embed = layers.ParamModule(cfg, defs["embed"], device, tp)
        self.final_norm = layers.Norm(cfg, device, tp)
        if not cfg.tie_embeddings:
            self.head = layers.tp_param(cfg, defs["head"], device, tp)
        self.groups = nn.ModuleDict({
            name: nn.ModuleList(_group_module(cfg, kind, device, tp) for _ in range(n))
            for name, n, kind in layer_groups(cfg)})


# ---------------------------------------------------------------------------
# Decode-cache definitions
# ---------------------------------------------------------------------------


def _kv_defs(cfg: ModelConfig, batch: int, s: int, n: int, long_ctx: bool,
             inner: int = 0) -> Dict:
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    seq_l = "long_seq" if long_ctx else "seq"
    lead = (n, inner) if inner else (n,)
    lead_l = ("layers", None) if inner else ("layers",)
    return {
        "k": PD(lead + (batch, s, hk, hd),
                lead_l + ("batch", seq_l, None, None), "zeros"),
        "v": PD(lead + (batch, s, hk, hd),
                lead_l + ("batch", seq_l, None, None), "zeros"),
    }


def decode_cache_defs(cfg: ModelConfig, batch: int, s: int, long_ctx: bool = False) -> Dict:
    ring_w = min(s, cfg.local_window) if cfg.ring_local_cache else 0
    groups = {}
    for name, n, kind in layer_groups(cfg):
        if kind == "attn_local" and ring_w:
            groups[name] = _kv_defs(cfg, batch, ring_w, n, False)
        elif kind in ("attn", "attn_moe", "attn_local"):
            groups[name] = _kv_defs(cfg, batch, s, n, long_ctx)
        elif kind == "attn_period":
            per = cfg.locals_per_global + 1
            if ring_w:
                groups[name] = {
                    "local": _kv_defs(cfg, batch, ring_w, n, False, inner=per - 1),
                    "global": _kv_defs(cfg, batch, s, n, long_ctx, inner=1),
                }
            else:
                groups[name] = _kv_defs(cfg, batch, s, n, long_ctx, inner=per)
        elif kind == "ssm":
            groups[name] = _stack(mamba2.ssm_cache_defs(cfg, batch), n)
        elif kind == "jamba":
            groups[name] = {
                "attn": _kv_defs(cfg, batch, s, n, long_ctx),
                "mamba": _stack(
                    _stack(mamba2.ssm_cache_defs(cfg, batch), cfg.attn_period - 1), n
                ),
            }
    # vlm: prefix patch tokens live in the cache; s already includes them
    return groups


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed.tok[tokens.long()]
    if cfg.family == "audio":
        return x
    # sqrt(d_model) is cast to the activation dtype BEFORE the multiply, as
    # the reference does (bfloat16: sqrt(2048) -> 45.25)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def _head(cfg: ModelConfig, model: nn.Module) -> torch.Tensor:
    return model.embed.tok.T if cfg.tie_embeddings else model.head


def lm_logits(cfg: ModelConfig, model: nn.Module, h: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(h, _head(cfg, model))
    if cfg.padded_vocab != cfg.vocab:  # mask dead pad rows, in the logits' dtype
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def chunked_xent(
    cfg: ModelConfig,
    model: nn.Module,
    h: torch.Tensor,  # (B, L, d) final hidden
    labels: torch.Tensor,  # (B, L) int; -1 = ignore
    chunk: int = 1024,
    rows=None,
) -> torch.Tensor:
    """Cross-entropy without materializing full (B, L, V) logits. ``rows``
    (a ``FullyShardedData`` whose other data ranks' rows other processes
    hold) sums the loss and the valid tokens over the data axes."""
    b, l, d = h.shape
    chunk = min(chunk, l)
    while l % chunk:
        chunk //= 2
    head = _head(cfg, model)
    pad_mask = None
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.zeros(cfg.padded_vocab, dtype=torch.float32, device=h.device)
        pad_mask[cfg.vocab:] = -1e30
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for ci in range(l // chunk):
        hc = h[:, ci * chunk:(ci + 1) * chunk]
        yc = labels[:, ci * chunk:(ci + 1) * chunk].long()
        logits = torch.matmul(hc, head).float()
        if pad_mask is not None:
            logits = logits + pad_mask
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp_min(yc, 0)[..., None])[..., 0]
        valid = (yc >= 0).float()
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    if rows is not None:
        tot, cnt = rows.batch_sum(tot), rows.batch_sum(cnt)
    return tot / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# Full-model passes
# ---------------------------------------------------------------------------


def _stack_kv(kvs):
    return {"k": torch.stack([kv[0] for kv in kvs]), "v": torch.stack([kv[1] for kv in kvs])}


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` and
    autograd is recording: the reference's ``jax.checkpoint`` of each scan
    body, so the unit is one layer (one period for ``attn_period`` and
    jamba), whose activations the backward pass recomputes."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _slots(target) -> list:
    """The FSDP-split parameter slots of ``target`` (a module, or a
    ``(module, name)`` pair) not gathered yet, in the byte model's order:
    by the reference path, then the stacked index."""
    if isinstance(target, tuple):
        mod, name = target
        prm = mod._parameters[name]
        found = [((), mod, name, prm)]
    else:
        found = []
        for mname, sub in target.named_modules():
            for pname, prm in sub._parameters.items():
                parts = (mname.split(".") if mname else []) + [pname]
                key = (tuple(p for p in parts if not p.isdigit()),
                       tuple(int(p) for p in parts if p.isdigit()))
                found.append((key, sub, pname, prm))
        found.sort(key=lambda t: t[0])
    return [(sub, name, prm) for _, sub, name, prm in found
            if isinstance(prm, nn.Parameter) and getattr(prm, "fsdp_dim", None) is not None]


@contextlib.contextmanager
def gathered(model: nn.Module, *targets):
    """FSDP: inside the block each FSDP-split parameter of ``targets``
    (modules, or ``(module, name)`` pairs) is its gathered tensor (what the
    model axis alone holds; ``FullyShardedData.gather_param``), whose
    gradient is reduce-scattered back to the held blocks; after it the
    held blocks are back and the gathered tensors are free. A parameter
    already gathered by an enclosing block is left as it is. Without FSDP
    it does nothing."""
    fs = getattr(model, "fsdp", None)
    if fs is None:
        yield
        return
    swapped = []
    try:
        for target in targets:
            for sub, name, prm in _slots(target):
                sub._parameters[name] = fs.gather_param(prm)
                swapped.append((sub, name, prm))
        yield
    finally:
        for sub, name, prm in swapped:
            sub._parameters[name] = prm


def unit(cfg: ModelConfig, model: nn.Module, module: nn.Module, fn, *args):
    """``fn(*args)``, one unit of ``module``'s parameters, under
    :func:`remat`; with FSDP the unit's parameters gathered inside it (so
    remat's recompute gathers them again)."""
    if getattr(model, "fsdp", None) is None:
        return remat(cfg, fn, *args)

    def run(*a):
        with gathered(model, module):
            return fn(*a)

    return remat(cfg, run, *args)


def head_scope(cfg: ModelConfig, model: nn.Module):
    """Where the head is used: an untied head gathered (a tied one is
    gathered for the whole pass, :func:`pass_scope`)."""
    if cfg.tie_embeddings or getattr(model, "fsdp", None) is None:
        return contextlib.nullcontext()
    return gathered(model, (model, "head"))


def pass_scope(cfg: ModelConfig, model: nn.Module):
    """A whole pass: a tied embedding table gathered once for the
    embedding and the head."""
    if not cfg.tie_embeddings:
        return contextlib.nullcontext()
    return gathered(model, model.embed)


def _period_fwd(cfg: ModelConfig, period: nn.ModuleList, x):
    """One ``attn_period`` period: -> (x, [(k, v) of each layer])."""
    kvs = []
    for j, blk in enumerate(period):
        x, kv = blk(x, _period_window(cfg, j))
        kvs.append(kv)
    return x, kvs


def _with_prefix(cfg: ModelConfig, model: LM, x: torch.Tensor, patches) -> torch.Tensor:
    """The embedded tokens in the compute dtype, the VLM's patch prefix
    (``vit_proj``, replicated over the model axis) before them."""
    if cfg.family == "vlm":
        pe = torch.matmul(patches.to(x.dtype), model.embed.vit_proj)
        x = torch.cat([pe, x], dim=1)
    return x.to(DTYPES[cfg.compute_dtype])


def forward_hidden(
    cfg: ModelConfig,
    model: LM,
    tokens: torch.Tensor,  # (B, L_text)
    *,
    patches: Optional[torch.Tensor] = None,  # vlm: (B, n_patches, patch_dim)
    want_cache: bool = False,
    tp=None,
):
    """Full-sequence pass -> final hidden (B, L, d) (+ cache when asked).
    A sharded model (``model.tp``) runs tensor-parallel; ``tp`` replaces its
    :class:`~repro_torch.core.collectives.TensorParallel` for this pass
    (e.g. one data group's view)."""
    tp = tp if tp is not None else getattr(model, "tp", None)
    if tp is not None:
        return _forward_hidden_tp(cfg, model, tokens, tp, want_cache, patches)
    with gathered(model, model.embed):
        x = _with_prefix(cfg, model, embed_tokens(cfg, model, tokens), patches)
    caches = {}

    for name, n, kind in layer_groups(cfg):
        blocks = model.groups[name]
        if kind in ("attn", "attn_moe", "attn_local"):
            window = cfg.local_window if kind == "attn_local" else None
            kvs = []
            for blk in blocks:
                x, kv = unit(cfg, model, blk, blk, x, window)
                if want_cache:
                    kvs.append(kv)
            if want_cache:
                caches[name] = _stack_kv(kvs)
        elif kind == "attn_period":
            kvs = []
            for period in blocks:
                x, inner = unit(cfg, model, period, _period_fwd, cfg, period, x)
                if want_cache:
                    kvs.append(_stack_kv(inner))
            if want_cache:
                caches[name] = {c: torch.stack([kv[c] for kv in kvs]) for c in ("k", "v")}
        elif kind == "ssm":
            states = []
            for blk in blocks:
                x, s = unit(cfg, model, blk, blk, x, want_cache)
                states.append(s)
            if want_cache:
                caches[name] = {k: torch.stack([s[k] for s in states]) for k in states[0]}
        elif kind == "jamba":
            kvs, mambas = [], []
            for period in blocks:
                x, c = unit(cfg, model, period, period, x, want_cache)
                if want_cache:
                    kvs.append(c[0])
                    mambas.append(c[1])
            if want_cache:
                caches[name] = {
                    "attn": _stack_kv(kvs),
                    "mamba": {k: torch.stack([m[k] for m in mambas]) for k in mambas[0]},
                }
    with gathered(model, model.final_norm):
        x = layers.apply_norm(cfg, model.final_norm, x)
    return (x, caches) if want_cache else x


def train_loss(cfg: ModelConfig, model: LM, batch: Dict[str, torch.Tensor], *,
               tp=None) -> torch.Tensor:
    """The mean next-token cross-entropy; differentiable in the model's
    parameters (``train.step`` takes its gradients). A sharded model's loss
    is vocab-parallel (:func:`chunked_xent_tp`)."""
    tp = tp if tp is not None else getattr(model, "tp", None)
    with pass_scope(cfg, model):
        h = forward_hidden(cfg, model, batch["tokens"], patches=batch.get("patches"), tp=tp)
        labels = batch["labels"]
        if cfg.family == "vlm":  # prefix patch positions carry no labels
            pad = torch.full((labels.shape[0], cfg.n_patches), -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        with head_scope(cfg, model):
            if tp is not None:
                return chunked_xent_tp(cfg, model, h, labels, tp.for_batch(h.shape[0]))
            return chunked_xent(cfg, model, h, labels, rows=getattr(model, "fsdp", None))


# --- prefill -----------------------------------------------------------------


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, patches=None):
    """Process the prompt; return (last-token logits, cache, pos)."""
    with pass_scope(cfg, model):
        h, caches = forward_hidden(cfg, model, tokens, patches=patches, want_cache=True)
        tp = getattr(model, "tp", None)
        with head_scope(cfg, model):
            if tp is not None:
                return (lm_logits_tp(cfg, model, h[:, -1], tp.for_batch(h.shape[0])), caches,
                        h.shape[1])
            return lm_logits(cfg, model, h[:, -1]), caches, h.shape[1]


# --- decode ------------------------------------------------------------------


def decode_step(
    cfg: ModelConfig,
    model: LM,
    cache: Dict,
    token: torch.Tensor,  # (B, 1) int
    pos: int,  # current cache length (includes any vlm prefix)
):
    """One decode step; returns (logits (B, V), cache). The cache's tensors
    are written in place and returned in the same dict."""
    with pass_scope(cfg, model):
        if getattr(model, "tp", None) is not None:
            return _decode_step_tp(cfg, model, cache, token, pos, model.tp)
        return _decode_step(cfg, model, cache, token, pos)


def _period_decode(cfg: ModelConfig, period: nn.ModuleList, x, gc: Dict, i: int, pos: int,
                   tp=None):
    """One ``attn_period`` period of a decode step (plain, or over the
    model axis with ``tp``): its layers against group cache ``gc``'s
    period ``i``."""
    jl = 0
    for j in range(cfg.locals_per_global + 1):
        w = _period_window(cfg, j)
        if not cfg.ring_local_cache:
            args, kw = (gc["k"][i, j], gc["v"][i, j], pos), {"window": w}
        elif w is None:
            args, kw = (gc["global"]["k"][i, 0], gc["global"]["v"][i, 0], pos), {}
        else:
            loc = gc["local"]
            args, kw = (loc["k"][i, jl], loc["v"][i, jl], pos), {"ring": True}
            jl += 1
        if tp is None:
            x, _, _ = period[j].decode(x, *args, **kw)
        else:
            x = period[j].decode_tp(x, *args, tp, **kw)
    return x


def _decode_step(cfg: ModelConfig, model: LM, cache: Dict, token: torch.Tensor, pos: int):
    """:func:`decode_step` of an unsharded (or FSDP-only) model."""
    with gathered(model, model.embed):
        x = embed_tokens(cfg, model, token).to(DTYPES[cfg.compute_dtype])
    for name, n, kind in layer_groups(cfg):
        blocks = model.groups[name]
        gc = cache[name]
        if kind in ("attn", "attn_moe", "attn_local"):
            window = cfg.local_window if kind == "attn_local" else None
            ring = cfg.ring_local_cache and kind == "attn_local"
            for i, blk in enumerate(blocks):
                x, _, _ = unit(cfg, model, blk, blk.decode, x, gc["k"][i], gc["v"][i], pos,
                               window, ring)
        elif kind == "attn_period":
            for i, period in enumerate(blocks):
                x = unit(cfg, model, period, _period_decode, cfg, period, x, gc, i, pos)
        elif kind == "ssm":
            for i, blk in enumerate(blocks):
                x, st = unit(cfg, model, blk, blk.decode, x, {k: v[i] for k, v in gc.items()})
                for k, v in st.items():
                    gc[k][i] = v
        elif kind == "jamba":
            cm = gc["mamba"]
            for i, period in enumerate(blocks):
                x = unit(cfg, model, period, period.decode, x, gc["attn"]["k"][i],
                         gc["attn"]["v"][i], {k: v[i] for k, v in cm.items()}, pos)
    with gathered(model, model.final_norm):
        x = layers.apply_norm(cfg, model.final_norm, x)
    with head_scope(cfg, model):
        logits = lm_logits(cfg, model, x[:, 0])
    return logits, cache


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------
#
# A sharded model (``model.tp``, a
# :class:`~repro_torch.core.collectives.TensorParallel`) splits the
# vocabulary of the embedding and the head over the model axis: the
# embedding looks up the rows its shard holds and the partial rows are
# all-reduced; the logits are column-parallel (all-gathered for serving);
# the loss takes a vocab-parallel log-sum-exp (a max all-reduce, then an
# all-reduce of the shifted exponentials' sums and of the target logit,
# which its owner alone holds). The padded vocabulary's dead columns fall
# in the last shard and are masked there.


def _vocab_cols(tp, width: int, device) -> torch.Tensor:
    """int64[n, width]: the global vocabulary column of each held shard's
    columns."""
    return tp.local_index(device)[:, None] * width + torch.arange(width, device=device)


def embed_tokens_tp(cfg: ModelConfig, model: LM, tokens: torch.Tensor, tp) -> torch.Tensor:
    """:func:`embed_tokens` with the table split over the vocabulary: each
    rank's rows for the tokens it holds (zeros elsewhere), all-reduced."""
    if not model.embed.split("tok"):
        return embed_tokens(cfg, model, tokens)
    tab = model.embed.tok  # (n, V/M, d)
    n, width = tab.shape[:2]
    idx = tokens.long()[None] - tp.local_index(tokens.device)[:, None, None] * width
    inside = (idx >= 0) & (idx < width)
    rows = tab[torch.arange(n, device=tab.device)[:, None, None], idx.clamp(0, width - 1)]
    x = tp.reduce(rows * inside[..., None].to(rows.dtype))
    if cfg.family == "audio":  # the decoder's embedding is not scaled
        return x
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def _head_tp(cfg: ModelConfig, model: LM):
    """The head's held blocks (n, d, V/M), or None when it is replicated."""
    if cfg.tie_embeddings:
        return model.embed.tok.transpose(-1, -2) if model.embed.split("tok") else None
    return model.head if model.head.tp_dim is not None else None


def lm_logits_tp(cfg: ModelConfig, model: LM, h: torch.Tensor, tp) -> torch.Tensor:
    """:func:`lm_logits` column-parallel over the vocabulary, the shards
    all-gathered: the replicated (..., V) logits."""
    head = _head_tp(cfg, model)
    if head is None:
        return lm_logits(cfg, model, h)
    logits = layers.bmm(tp.copy(h), head)  # (n, ..., V/M)
    if cfg.padded_vocab != cfg.vocab:  # mask dead pad columns, in the last shard
        n, width = head.shape[0], head.shape[-1]
        dead = _vocab_cols(tp, width, h.device) >= cfg.vocab
        logits = logits.masked_fill(dead.reshape((n,) + (1,) * (logits.dim() - 2) + (width,)),
                                    -1e30)
    return tp.gather(logits, -1)


def chunked_xent_tp(cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
                    tp, chunk: int = 1024) -> torch.Tensor:
    """:func:`chunked_xent` with a vocab-parallel log-sum-exp. Where other
    processes hold other data groups' rows (``tp.split_rows``) the sums of
    the losses and of the valid tokens are all-reduced over the data axes,
    so the value and its gradient are the global batch's mean."""
    b, l, d = h.shape
    chunk = min(chunk, l)
    while l % chunk:
        chunk //= 2
    head = _head_tp(cfg, model)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    if head is None:
        full = _head(cfg, model)
    else:
        n, width = head.shape[0], head.shape[-1]
        hm = tp.copy(h)
        lo = tp.local_index(h.device)[:, None, None] * width
        pad_mask = None
        if cfg.padded_vocab != cfg.vocab:
            pad_mask = torch.zeros((n, width), dtype=torch.float32, device=h.device)
            pad_mask.masked_fill_(_vocab_cols(tp, width, h.device) >= cfg.vocab, -1e30)
    for ci in range(l // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        yc = labels[:, sl].long()
        y0 = torch.clamp_min(yc, 0)
        if head is None:
            logits = torch.matmul(h[:, sl], full).float()
            if cfg.padded_vocab != cfg.vocab:
                logits[..., cfg.vocab:] = -1e30
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y0[..., None])[..., 0]
        else:
            logits = layers.bmm(hm[:, :, sl], head).float()  # (n, B, c, V/M)
            if pad_mask is not None:
                logits = logits + pad_mask[:, None, None, :]
            mx = tp.max(logits.amax(dim=-1))
            lse = torch.log(tp.reduce(torch.exp(logits - mx[..., None]).sum(dim=-1))) + mx
            local = y0[None] - lo
            inside = ((local >= 0) & (local < width)).to(logits.dtype)
            picked = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
            gold = tp.reduce(picked * inside)
        valid = (yc >= 0).float()
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    tot, cnt = tp.batch_sum(tot), tp.batch_sum(cnt)
    return tot / torch.clamp_min(cnt, 1.0)


def _period_fwd_tp(cfg: ModelConfig, period: nn.ModuleList, x, tp, want_kv: bool):
    kvs = []
    for j, blk in enumerate(period):
        x, kv = blk.forward_tp(x, tp, _period_window(cfg, j), want_kv)
        kvs.append(kv)
    return x, kvs


def _forward_hidden_tp(cfg: ModelConfig, model: LM, tokens: torch.Tensor, tp,
                       want_cache: bool, patches=None):
    """:func:`forward_hidden` over the model axis."""
    tp = tp.for_batch(tokens.shape[0])
    with gathered(model, model.embed):
        x = _with_prefix(cfg, model, embed_tokens_tp(cfg, model, tokens, tp), patches)
    caches = {}
    for name, n, kind in layer_groups(cfg):
        blocks = model.groups[name]
        kvs = []
        if kind in ("attn", "attn_moe", "attn_local"):
            window = cfg.local_window if kind == "attn_local" else None
            for blk in blocks:
                x, kv = unit(cfg, model, blk, blk.forward_tp, x, tp, window, want_cache)
                kvs.append(kv)
            if want_cache:
                caches[name] = _stack_kv(kvs)
        elif kind == "attn_period":
            for period in blocks:
                x, inner = unit(cfg, model, period, _period_fwd_tp, cfg, period, x, tp,
                                want_cache)
                if want_cache:
                    kvs.append(_stack_kv(inner))
            if want_cache:
                caches[name] = {c: torch.stack([kv[c] for kv in kvs]) for c in ("k", "v")}
        elif kind == "ssm":
            for blk in blocks:
                x, st = unit(cfg, model, blk, blk.forward_tp, x, tp, want_cache)
                kvs.append(st)
            if want_cache:
                caches[name] = {k: torch.stack([st[k] for st in kvs]) for k in kvs[0]}
        elif kind == "jamba":
            for period in blocks:
                x, c = unit(cfg, model, period, period.forward_tp, x, tp, want_cache)
                kvs.append(c)
            if want_cache:
                caches[name] = {
                    "attn": _stack_kv([c[0] for c in kvs]),
                    "mamba": {k: torch.stack([c[1][k] for c in kvs]) for k in kvs[0][1]},
                }
    with gathered(model, model.final_norm):
        x = layers.apply_norm(cfg, model.final_norm, x)
    return (x, caches) if want_cache else x


def _decode_step_tp(cfg: ModelConfig, model: LM, cache: Dict, token: torch.Tensor,
                    pos: int, tp):
    """:func:`decode_step` over the model axis; the KV cache keeps the
    reference's (replicated) layout, the SSM states their held blocks."""
    tp = tp.for_batch(token.shape[0])
    with gathered(model, model.embed):
        x = embed_tokens_tp(cfg, model, token, tp).to(DTYPES[cfg.compute_dtype])
    for name, n, kind in layer_groups(cfg):
        blocks = model.groups[name]
        gc = cache[name]
        if kind in ("attn", "attn_moe", "attn_local"):
            window = cfg.local_window if kind == "attn_local" else None
            ring = cfg.ring_local_cache and kind == "attn_local"
            for i, blk in enumerate(blocks):
                x = unit(cfg, model, blk, blk.decode_tp, x, gc["k"][i], gc["v"][i], pos, tp,
                         window, ring)
        elif kind == "attn_period":
            for i, period in enumerate(blocks):
                x = unit(cfg, model, period, _period_decode, cfg, period, x, gc, i, pos, tp)
        elif kind == "ssm":
            for i, blk in enumerate(blocks):
                x, st = unit(cfg, model, blk, blk.decode_tp, x,
                             {k: v[i] for k, v in gc.items()}, tp)
                for k, v in st.items():
                    gc[k][i] = v
        elif kind == "jamba":
            cm = gc["mamba"]
            for i, period in enumerate(blocks):
                x = unit(cfg, model, period, period.decode_tp, x, gc["attn"]["k"][i],
                         gc["attn"]["v"][i], {k: v[i] for k, v in cm.items()}, pos, tp)
    with gathered(model, model.final_norm):
        x = layers.apply_norm(cfg, model.final_norm, x)
    with head_scope(cfg, model):
        return lm_logits_tp(cfg, model, x[:, 0], tp), cache


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=DTYPES[name]).element_size()


def tp_calls(cfg: ModelConfig, kind: str, rows: int, seq: int, size: int,
             chunk: int = 1024) -> List[Tuple[str, int]]:
    """The byte model of a sharded pass: the model-axis collectives one rank
    makes, as (HLO kind, operand bytes) in the order the pass makes them
    (each one's wire bytes are ``(size - 1)`` times its operand's).

    ``kind``: ``prefill`` (``seq`` prompt tokens, after the VLM's patch
    prefix; whisper's encoder runs its ``n_frames`` first), ``decode`` (one
    token), or ``train`` (the loss and its gradient: the forward's calls,
    then the backward's, remat's recomputed forward calls included, in the
    order of the layers, not autograd's); ``rows`` is one data group's
    batch rows. Mirrors the functions above (and ``encdec``'s) call by
    call."""
    a, pb = _itemsize(cfg.compute_dtype), _itemsize(cfg.param_dtype)
    logit_b = torch.promote_types(DTYPES[cfg.compute_dtype], DTYPES[cfg.param_dtype]).itemsize
    hq, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    hd = cfg.resolved_head_dim if hq else 0
    heads = bool(hq) and hq % size == 0
    kv = bool(hk) and hk % size == 0
    vocab = cfg.padded_vocab % size == 0
    l = 1 if kind == "decode" else seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    x = rows * l * d * a  # one replicated activation
    fwd: List[Tuple[str, int]] = []  # the forward's calls
    bwd: List[Tuple[str, int]] = []  # the backward's (train)
    train = kind == "train"

    def mlp(ff: int, xx: int = x, partial: bool = False):
        if ff % size:
            return []
        if train:
            bwd.append(("all-reduce", xx))
        return [] if partial else [("all-reduce", xx)]

    def kv_grads(n: int) -> None:
        """The backward of a rank's selection of replicated kv heads."""
        if train and not kv:
            bwd.extend([("all-reduce", rows * n * hk * hd * a)] * 2)

    def attn(n: int = l, cache: bool = True) -> List[Tuple[str, int]]:
        """Self-attention over ``n`` tokens (``cache``: it keeps a cache)."""
        if not heads:
            return []
        xx = rows * n * d * a
        if train:
            bwd.append(("all-reduce", xx))
            if cfg.qk_norm:
                bwd.append(("all-reduce", hd * pb))
                if kv:
                    bwd.append(("all-reduce", hd * pb))
        kv_grads(n)
        out = [("all-reduce", xx)]
        gathers = [("all-gather", rows * n * (hk // size) * hd * a)] * 2
        if kv and cache and kind == "prefill":  # the cache's k/v, after the output
            out.extend(gathers)
        elif kv and kind == "decode":  # the new entry, before attending
            out[-1:-1] = gathers
        return out

    def cross() -> List[Tuple[str, int]]:
        """Cross attention of ``l`` decoder tokens to the ``n_frames``."""
        if not heads:
            return []
        f = cfg.n_frames
        out: List[Tuple[str, int]] = []
        if kind != "decode":
            if kv and kind == "prefill":  # the cross cache's k/v
                out.extend([("all-gather", rows * f * (hk // size) * hd * a)] * 2)
            if train:
                if kv:
                    bwd.append(("all-reduce", rows * f * d * a))
                    if cfg.qk_norm:
                        bwd.append(("all-reduce", hd * pb))
            kv_grads(f)
        if train:
            bwd.append(("all-reduce", x))
            if cfg.qk_norm:
                bwd.append(("all-reduce", hd * pb))
        return out + [("all-reduce", x)]

    def moe() -> List[Tuple[str, int]]:
        e, k = cfg.n_experts, cfg.experts_per_token
        out: List[Tuple[str, int]] = []
        if e % size == 0:
            out.append(("all-gather", rows * l * (e // size) * 4))
            if train:
                bwd.append(("all-reduce", rows * l * d * 4))
                bwd.append(("all-gather", rows * (e // size) * moe_mod.capacity(cfg, l) * d * a))
                bwd.append(("all-reduce", rows * l * k * 4))
            shared = cfg.d_expert * cfg.n_shared_experts if cfg.n_shared_experts else 0
            if shared:
                mlp(shared, partial=True)
            out.append(("all-reduce", x))
        elif cfg.n_shared_experts:
            out.extend(mlp(cfg.d_expert * cfg.n_shared_experts))
        return out

    def ssm() -> List[Tuple[str, int]]:
        """The mamba mixer: the straddling heads' gather, the gate norm's
        statistic, ``wo``'s partial sums."""
        width = cfg.d_inner
        if width % size:
            return []
        stat = rows * l * 4
        whole = cfg.n_ssm_heads % size == 0
        cols = ("all-gather", rows * l * (width // size) * a)
        out = ([] if whole else [cols]) + [("all-reduce", stat), ("all-reduce", x)]
        if train:
            bwd.append(("all-reduce", x))
            bwd.append(("all-reduce", rows * l * 2 * cfg.ssm_state * a) if whole else cols)
            bwd.append(("all-reduce", stat))
        return out

    def ffn_of(moe_layer: bool) -> Tuple[List[Tuple[str, int]], bool]:
        """(the FFN's calls, whether it ends its unit in an all-reduce
        whose output nothing saves)."""
        calls = moe() if moe_layer else mlp(cfg.d_ff)
        return calls, calls[-1:] == [("all-reduce", x)] and _ffn_split(cfg, moe_layer, size)

    def encoder_units():
        """Whisper's encoder layers: (forward calls, trailing all-reduce or
        not) of each remat unit."""
        f = cfg.n_frames
        for _ in range(cfg.encoder_layers):
            calls = attn(f, cache=False) + mlp(cfg.d_ff, rows * f * d * a)
            yield calls, bool(calls) and cfg.d_ff % size == 0

    def decoder_units():
        for _ in range(cfg.n_layers):
            yield attn() + cross() + mlp(cfg.d_ff), cfg.d_ff % size == 0

    def units():
        """The decoder-only stack's remat units, as :func:`encoder_units`."""
        for _, n, group in layer_groups(cfg):
            for _ in range(n):
                calls: List[Tuple[str, int]] = []
                tail = False
                if group == "ssm":
                    calls = ssm()
                    tail = bool(calls)
                elif group == "jamba":
                    for j in range(cfg.attn_period):
                        calls.extend(attn() if j == cfg.attn_offset else ssm())
                        more, tail = ffn_of(cfg.is_moe_layer(j))
                        calls.extend(more)
                else:
                    per = cfg.locals_per_global + 1 if group == "attn_period" else 1
                    for _ in range(per):
                        calls.extend(attn())
                        more, tail = ffn_of(group == "attn_moe")
                        calls.extend(more)
                yield calls, tail

    def run(us) -> None:
        for calls, tail in us:
            fwd.extend(calls)
            if train and cfg.remat:
                # the recompute stops at the last op whose saved tensors the
                # backward needs (checkpoint's early stop): a unit's trailing
                # all-reduce, whose output nothing saves, is not rerun
                bwd.extend(calls[:len(calls) - int(tail)])

    if cfg.family == "audio" and kind != "decode":
        run(encoder_units())
    if vocab:
        fwd.append(("all-reduce", rows * (1 if kind == "decode" else seq) * d * pb))
    run(decoder_units() if cfg.family == "audio" else units())
    if vocab:
        if train:
            bwd.append(("all-reduce", x))
            c = min(chunk, l)
            while l % c:
                c //= 2
            for _ in range(l // c):
                fwd.extend([("all-reduce", rows * c * 4)] * 3)
        else:
            fwd.append(("all-gather", rows * (cfg.padded_vocab // size) * logit_b))
    return fwd + bwd


def _ffn_split(cfg: ModelConfig, moe: bool, size: int) -> bool:
    """Whether a layer's FFN ends in the model-axis all-reduce."""
    if moe:
        return cfg.n_experts % size == 0 or bool(
            cfg.n_shared_experts and (cfg.d_expert * cfg.n_shared_experts) % size == 0)
    return cfg.d_ff % size == 0


def tp_stats(calls: List[Tuple[str, int]], size: int) -> Dict:
    """``{kind: {count, operand_bytes, wire_bytes}}`` of a byte model's list
    over ``size`` ranks (:func:`tp_calls`'s, :func:`fsdp_calls`'s, with the
    optimizer's), as ``TensorParallel.stats`` and
    ``FullyShardedData.stats`` record them: a rank sends ``size - 1``
    blocks of each call, a reduce-scatter's block its operand over
    ``size``."""
    from repro_torch.core.collectives import empty_stats

    out = empty_stats()
    for kind, nbytes in calls:
        rec = out[kind]
        rec["count"] += 1
        rec["operand_bytes"] += float(nbytes)
        block = nbytes // size if kind == "reduce-scatter" else nbytes
        rec["wire_bytes"] += float((size - 1) * block)
    return out


def fsdp_calls(cfg: ModelConfig, kind: str, mesh, rules) -> List[Tuple[str, int]]:
    """The byte model of a pass's FSDP collectives on ``mesh`` under FSDP
    ``rules``: one rank's calls as (HLO kind, operand bytes), in the order
    the pass makes them (``train``: then remat's recomputed gathers, then
    each gathered leaf's reduce-scatter; compare it sorted, autograd orders
    the backward). Each leaf an ``embed`` dimension splits
    (``shd.held_block``) is one all-gather of its block (the model axis's
    block cut over the data axes) where it is used: the embedding
    (tied: for the whole pass), each remat unit's leaves when the unit
    runs (by reference path, then stacked index), whisper's encoder norm,
    the final norm, the untied head. A reduce-scatter's operand is the
    whole gradient, the block times the data axes' size."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import encdec

    fax = tuple(a for a in rules.fsdp if a in mesh.axis_names)
    size = 1
    for a in fax:
        size *= mesh.shape[a]

    def gathers(tree) -> List[int]:
        out = []
        for _, pd in sorted_leaves(tree):
            nl = 0
            while nl < len(pd.logical) and pd.logical[nl] == "layers":
                nl += 1
            block, f = shd.held_block(PD(pd.shape[nl:], pd.logical[nl:]), rules, mesh)
            if f is None:
                continue
            nbytes = shd.resolve_dtype(pd, cfg.param_dtype).itemsize
            for n in block:
                nbytes *= n
            reps = 1
            for n in pd.shape[:nl]:
                reps *= n
            out.extend([nbytes] * reps)
        return out

    if cfg.family == "audio":
        defs = encdec.param_defs(cfg)
        enc = [] if kind == "decode" else (
            [gathers(encdec._enc_block_defs(cfg))] * cfg.encoder_layers)
        units = enc + [gathers(encdec._dec_block_defs(cfg))] * cfg.n_layers
        fwd = gathers(defs["embed"])
        fwd += [b for u in enc for b in u]
        if kind != "decode":
            fwd += gathers(defs["enc_norm"])
        fwd += [b for u in units[len(enc):] for b in u]
    else:
        defs = param_defs(cfg)
        units = [gathers(_GROUP_DEFS[k](cfg)) for _, n, k in layer_groups(cfg) for _ in range(n)]
        fwd = gathers(defs["embed"]) + [b for u in units for b in u]
    fwd += gathers(defs["final_norm"])
    if not cfg.tie_embeddings:
        fwd += gathers({"head": defs["head"]})
    calls = [("all-gather", b) for b in fwd]
    if kind == "train":
        if cfg.remat:
            calls += [("all-gather", b) for u in units for b in u]
        calls += [("reduce-scatter", b * size) for b in fwd]
    return calls
