"""Serving sharded over the model axis: the port's prefill, teacher-forced
decode and greedy ``generate`` on ``SimMesh((2, 4),
("data", "model"))`` against the JAX package's on ``mesh_dm``, for the six
reduced dense and MoE configs (plus split kv heads with a padded
vocabulary, and gemma3's ring cache): logits and caches within the LM
tolerance (1e-4), greedy tokens equal, the loss within 1e-5. Every pass's
model-axis collectives equal the port's byte model (``lm.tp_calls``) call
for call, and each rank's bytes its wire bytes. Without a model axis the
entry points compute exactly what the unsharded model computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as ref_engine
from repro.models import api as ref_api
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api, lm
from repro_torch.serve import engine
from test_torch_lm_common import assert_close, assert_tree_close
from test_torch_tp_common import (ARCHS, ATOL, BATCH, KV_SPLIT, MESH, ROWS, RTOL, RULES, SEQ,
                                  SIZE, configs_of, one_torch_thread,  # noqa: F401
                                  place_params, place_rows, port_sharded, ref_params,
                                  ref_rules, tokens)

PROMPT = SEQ - 4
STEPS = 4
NEW = 4  # PROMPT + NEW == SEQ: the teacher-forced steps' cache shape
CASES = [(a, None) for a in ARCHS] + [KV_SPLIT]
IDS = [a if c is None else f"{a}-{'-'.join(c)}" for a, c in CASES]


@pytest.fixture(scope="module")
def reference(mesh_dm):
    """Each case's reference run on ``mesh_dm``, computed once: the
    weights, the prefill's logits and cache, the teacher-forced decode
    steps' logits, the greedy tokens and the loss."""
    memo = {}

    def run(arch, changes):
        key = (arch, tuple(sorted((changes or {}).items())))
        if key in memo:
            return memo[key]
        ref_cfg, cfg = configs_of(arch, changes)
        params = ref_params(ref_cfg)
        placed = place_params(ref_cfg, params, mesh_dm)
        rules = ref_rules(mesh_dm)
        data = tokens(cfg)
        ins = place_rows({"tokens": data["tokens"][:, :PROMPT]}, mesh_dm)
        prefill = jax.jit(ref_api.prefill_fn(ref_cfg, rules, mesh_dm))
        logits, cache, pos = prefill(placed, ins)
        out = {"params": params, "data": data, "prefill": np.asarray(logits),
               "cache": jax.tree.map(np.asarray, cache)}
        cache = ref_engine.prepare_decode_cache(ref_cfg, cache, PROMPT, SEQ)
        decode = jax.jit(ref_api.decode_fn(ref_cfg, rules, mesh_dm))
        # every step's cache laid out as the first's: one compile
        layout = jax.tree.map(lambda a: a.sharding, cache)
        steps = []
        for i in range(STEPS):
            tok = jnp.asarray(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            dl, cache = decode(placed, jax.device_put(cache, layout), tok, jnp.int32(PROMPT + i))
            steps.append(np.asarray(dl))
        out["decode"] = steps
        out["generate"] = ref_greedy(ref_cfg, placed, ins["tokens"], prefill, decode, layout)
        memo[key] = (cfg, out)
        return memo[key]

    return run


def ref_greedy(ref_cfg, params, prompts, prefill, decode, layout):
    """``repro.serve.engine.generate`` at temperature 0 with already jitted
    ``prefill`` and ``decode`` (the generate loop of the reference, its
    cache preparation and sampler; its own ``generate`` would compile both
    again): ``NEW`` tokens to ``SEQ``, the decode steps' cache shape and
    ``layout``."""
    logits, cache, pos = prefill(params, {"tokens": prompts})
    cache = ref_engine.prepare_decode_cache(ref_cfg, cache, PROMPT, PROMPT + NEW)
    tok = ref_engine.sample(logits, None)
    out = [tok]
    for i in range(NEW - 1):
        logits, cache = decode(params, jax.device_put(cache, layout), tok[:, None], pos + i)
        tok = ref_engine.sample(logits, None)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], 1)


def calls_of(model):
    return list(model.tp.calls)


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_prefill_and_cache_match_reference(reference, arch, changes):
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    prompts = torch.from_numpy(ref["data"]["tokens"][:, :PROMPT])
    with torch.no_grad():
        logits, cache, pos = api.prefill_fn(cfg, RULES, MESH)(model, {"tokens": prompts})
    assert pos == PROMPT and logits.shape == (BATCH, cfg.padded_vocab)
    assert_close(logits, ref["prefill"], ATOL, RTOL, "prefill logits")
    assert_tree_close(cache, ref["cache"], ATOL, RTOL)
    want = lm.tp_calls(cfg, "prefill", BATCH // ROWS, PROMPT, SIZE)
    assert calls_of(model) == want
    assert model.tp.stats == lm.tp_stats(want, SIZE)
    assert list(model.tp.bytes_sent) == [sum((SIZE - 1) * b for _, b in want)] * MESH.ranks


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_decode_steps_match_reference(reference, arch, changes):
    """Four teacher-forced decode steps after a prefill; each step's
    collectives equal the byte model's decode step."""
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    data = ref["data"]
    with torch.no_grad():
        _, cache, _ = api.prefill_fn(cfg, RULES, MESH)(
            model, {"tokens": torch.from_numpy(data["tokens"][:, :PROMPT])})
        cache = engine.prepare_decode_cache(cfg, cache, PROMPT, SEQ)
        decode = api.decode_fn(cfg, RULES, MESH)
        want = lm.tp_calls(cfg, "decode", BATCH // ROWS, SEQ, SIZE)
        for i in range(STEPS):
            model.tp.reset()
            tok = torch.from_numpy(data["tokens"][:, PROMPT + i:PROMPT + i + 1])
            logits, cache = decode(model, cache, tok, PROMPT + i)
            assert_close(logits, ref["decode"][i], ATOL, RTOL, f"decode step {i}")
            assert calls_of(model) == want


@pytest.mark.parametrize("arch,changes", CASES, ids=IDS)
def test_generate_greedy_tokens_equal_reference(reference, arch, changes):
    cfg, ref = reference(arch, changes)
    model = port_sharded(cfg, ref["params"])
    prompts = torch.from_numpy(ref["data"]["tokens"][:, :PROMPT])
    got = engine.generate(cfg, model, prompts, NEW, rules=RULES, mesh=MESH)
    np.testing.assert_array_equal(got.tokens, ref["generate"])


def test_ring_cache_decode_equals_unsharded():
    """gemma3's ring cache (``ring_local_cache``: sliding-window layers
    decode against a window-wide ring) sharded: prefill and 4 decode steps
    equal the unsharded port's (whose ring path the LM tests hold to the
    reference) within the LM tolerance, each step's calls the byte
    model's."""
    _, cfg = configs_of("gemma3-27b", dict(ring_local_cache=True))
    plain = api.init_params(cfg, 0, device="cpu")
    sharded = api.shard(plain, RULES, MESH)
    data = torch.from_numpy(tokens(cfg)["tokens"])
    outs = []
    with torch.no_grad():
        for model, rules, mesh in ((plain, None, None), (sharded, RULES, MESH)):
            logits, cache, _ = api.prefill_fn(cfg, rules, mesh)(model, {"tokens": data[:, :PROMPT]})
            cache = engine.prepare_decode_cache(cfg, cache, PROMPT, SEQ)
            got = [logits]
            for i in range(STEPS):
                if model is sharded:
                    model.tp.reset()
                logits, cache = api.decode_fn(cfg, rules, mesh)(
                    model, cache, data[:, PROMPT + i:PROMPT + i + 1], PROMPT + i)
                got.append(logits)
            outs.append(got)
    for i, (a, b) in enumerate(zip(*outs)):
        assert_close(b, a.numpy(), ATOL, RTOL, f"step {i}")
    assert list(sharded.tp.calls) == lm.tp_calls(cfg, "decode", BATCH // ROWS, SEQ, SIZE)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b"])
def test_without_a_model_axis_nothing_changes(arch):
    """A mesh without a model axis: the entry points compute exactly what
    they compute with no mesh; a mesh with one refuses an unsharded model;
    ``to_reference`` of the sharded model is the unsharded one bit for bit;
    FSDP rules with a model axis build a model whose gathered leaves are
    the unsharded one's bit for bit and whose prefill is the
    tensor-parallel one's."""
    _, cfg = configs_of(arch)
    model = api.init_params(cfg, 0, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in tokens(cfg).items()}
    data_mesh = SimMesh(2)
    rules = rules_for_mesh(data_mesh)
    with torch.no_grad():
        a = api.prefill_fn(cfg)(model, data)
        b = api.prefill_fn(cfg, rules, data_mesh)(model, data)
        assert torch.equal(a[0], b[0]) and a[2] == b[2]
        assert torch.equal(api.train_loss_fn(cfg)(model, data),
                           api.train_loss_fn(cfg, rules, data_mesh)(model, data))
        with pytest.raises(ValueError, match="not sharded"):
            api.prefill_fn(cfg, RULES, MESH)(model, data)
    sharded = api.shard(model, RULES, MESH)
    for (pa, x), (pb, y) in zip(sorted(_flat(api.to_reference(model))),
                                sorted(_flat(api.to_reference(sharded)))):
        assert pa == pb and np.array_equal(x, y), pa
    fsdp_rules = rules_for_mesh(MESH, fsdp=True)
    fsdp = api.init_params(cfg, 0, device="cpu", rules=fsdp_rules, mesh=MESH)
    for (pa, x), (pb, y) in zip(sorted(_flat(api.to_reference(model))),
                                sorted(_flat(api.to_reference(fsdp)))):
        assert pa == pb and np.array_equal(x, y), pa
    with torch.no_grad():
        a = api.prefill_fn(cfg, RULES, MESH)(sharded, data)
        b = api.prefill_fn(cfg, fsdp_rules, MESH)(fsdp, data)
    assert torch.equal(a[0], b[0])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree
