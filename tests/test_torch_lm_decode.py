"""PyTorch port, every architecture at its reduced config: ``prefill``'s
logits and every cache leaf, then 4 teacher-forced decode steps' logits and
caches, against the JAX package.

Float32 on the CPU, atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro_torch.models import api
from repro_torch.serve import engine
from test_torch_lm_common import (ARCHS, as_jax, as_torch, assert_close, assert_tree_close,
                             batch, port_model, reduced, ref_params, to_numpy)

N_STEPS = 4


def prompt(cfg, l=24, seed=0):
    bt = batch(cfg, 2, l, seed)
    return {k: v for k, v in bt.items() if k != "labels"}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    ref_cfg, cfg = reduced(arch)
    params, model = ref_params(arch), port_model(arch)
    inputs = prompt(cfg)
    toks = inputs["tokens"]
    cut = toks.shape[1] - N_STEPS - 1
    pre = dict(inputs, tokens=toks[:, :cut])
    logits, cache, pos = api.prefill_fn(cfg)(model, as_torch(pre))
    rlogits, rcache, rpos = jax.jit(ref_api.prefill_fn(ref_cfg))(params, as_jax(pre))
    assert pos == int(rpos)
    assert_close(logits, rlogits, what="prefill logits")
    assert_tree_close(cache, to_numpy(rcache))

    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache = engine.pad_cache(cache, cut + prefix + N_STEPS + 1)
    rcache = ref_engine.pad_cache(rcache, cut + prefix + N_STEPS + 1)
    assert_tree_close(cache, to_numpy(rcache))
    dec = jax.jit(ref_api.decode_fn(ref_cfg))
    for i in range(N_STEPS):
        tok = toks[:, cut + i:cut + i + 1]
        logits, cache = api.decode_fn(cfg)(model, cache, torch.from_numpy(tok), pos + i)
        rlogits, rcache = dec(params, rcache, jnp.asarray(tok), rpos + i)
        assert_close(logits, rlogits, what=f"decode step {i} logits")
        assert_tree_close(cache, to_numpy(rcache))
