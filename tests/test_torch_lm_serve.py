"""PyTorch port, the LM serving engine and the model API's edges: greedy
``generate`` equal to the JAX package's (a dense model, the VLM, whisper),
determinism, the first token against the forward's argmax, ``sample``'s
top-k restriction and pad masking, ``pad_cache``'s path rules,
``init_params``'s laws, ``from_reference``'s refusals, the no-card refusal,
and the ``serve_lm`` CLI on the CPU (the counterparts of
``tests/test_serve.py``'s engine tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.launch import serve_lm
from repro_torch.models import api, lm
from repro_torch.serve import engine
from test_torch_lm_common import (as_torch, assert_tree_close, batch, port_model, reduced,
                             ref_params, to_numpy)


def tiny(pkg):
    """``tests/test_serve.py::_tiny`` in either package."""
    cfg = pkg.reduced(pkg.get_config("olmo-1b"))
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128, n_heads=2,
                               n_kv_heads=2, head_dim=32, vocab=256)


@pytest.fixture(scope="module")
def tiny_pair():
    ref_cfg, cfg = tiny(ref_configs), tiny(configs)
    params = ref_api.init_params(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, cfg, params, api.from_reference(cfg, to_numpy(params), device="cpu")


def test_greedy_generation_matches_reference(tiny_pair):
    ref_cfg, cfg, params, model = tiny_pair
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    r1 = engine.generate(cfg, model, torch.from_numpy(prompts), 8)
    r2 = engine.generate(cfg, model, torch.from_numpy(prompts), 8)
    want = ref_engine.generate(ref_cfg, params, jnp.asarray(prompts), 8)
    assert r1.tokens.shape == (2, 8) and r1.steps == 8
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    np.testing.assert_array_equal(r1.tokens, want.tokens)
    assert r1.tokens.min() >= 0 and r1.tokens.max() < cfg.vocab


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-26b", "whisper-medium",
                                  "jamba-v0.1-52b"])
def test_greedy_generation_matches_reference_by_family(arch):
    """A dense model, the VLM (patch prefix in the cache), whisper (cross
    caches left unpadded) and the hybrid (mamba states left unpadded)."""
    ref_cfg, cfg = reduced(arch)
    inputs = batch(cfg, 2, 16, seed=4)
    prompts = inputs.pop("tokens")
    inputs.pop("labels")
    got = engine.generate(cfg, port_model(arch), torch.from_numpy(prompts), 6,
                          extra_inputs=as_torch(inputs) or None)
    want = ref_engine.generate(ref_cfg, ref_params(arch), jnp.asarray(prompts), 6,
                               extra_inputs={k: jnp.asarray(v) for k, v in inputs.items()}
                               or None)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_greedy_matches_forward_argmax(tiny_pair):
    """Greedy generation == argmax over the full-forward logits, step 1."""
    _, cfg, _, model = tiny_pair
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 10)).astype(np.int32))
    r = engine.generate(cfg, model, prompts, 1)
    h = lm.forward_hidden(cfg, model, prompts)
    want = torch.argmax(lm.lm_logits(cfg, model, h[:, -1]), -1).numpy()
    np.testing.assert_array_equal(r.tokens[:, 0], want)


def test_sampled_generation_valid_and_repeatable(tiny_pair):
    _, cfg, _, model = tiny_pair
    prompts = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 6)).astype(np.int32))
    runs = [engine.generate(cfg, model, prompts, 5, temperature=1.0, top_k=k, seed=s)
            for k, s in ((0, 3), (0, 3), (0, 4), (5, 3))]
    for r in runs:
        assert r.tokens.shape == (2, 5)
        assert r.tokens.min() >= 0 and r.tokens.max() < cfg.vocab
    np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
    assert not np.array_equal(runs[0].tokens, runs[2].tokens)


def test_sample_top_k_restricts():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        t = engine.sample(logits, gen, temperature=1.0, top_k=2)
        assert t.dtype == torch.int32
        seen.add(int(t[0]))
    assert seen == {2, 3}
    assert int(engine.sample(logits)[0]) == 3  # greedy


def test_padded_vocab_never_sampled():
    """Pad rows of the padded vocabulary are masked to -1e30 in the logits'
    dtype, so neither greedy nor sampling returns a pad id."""
    _, cfg = reduced("qwen3-1.7b", vocab=2100)
    assert cfg.padded_vocab == 2304
    model = api.init_params(cfg, 0, device="cpu")
    model.embed.tok.data[cfg.vocab:] = 10.0  # pad rows would win unmasked
    h = torch.ones(3, cfg.d_model)
    for dt in (torch.float32, torch.bfloat16):
        logits = lm.lm_logits(cfg, model.to(dt), h.to(dt))
        assert logits.dtype == dt
        assert (logits[:, cfg.vocab:] == torch.tensor(-1e30, dtype=dt)).all()
        assert int(engine.sample(logits).max()) < cfg.vocab
        gen = torch.Generator().manual_seed(1)
        assert int(engine.sample(logits, gen, temperature=0.8, top_k=50).max()) < cfg.vocab


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-medium", "gemma3-27b"])
def test_pad_cache_is_path_aware(arch):
    """Self-attention K/V grow to max_len (rank 5 and the period groups' rank
    6); mamba states and whisper's cross K/V keep their shapes; the result
    equals the reference's pad_cache."""
    ref_cfg, cfg = reduced(arch)
    inputs = {k: v for k, v in batch(cfg, 2, 12).items() if k != "labels"}
    _, cache, pos = api.prefill_fn(cfg)(port_model(arch), as_torch(inputs))
    padded = engine.pad_cache(cache, pos + 7)
    rpadded = ref_engine.pad_cache(jax.tree.map(jnp.asarray, to_numpy(cache)), pos + 7)
    assert_tree_close(padded, to_numpy(rpadded), atol=0, rtol=0)
    for path, leaf in sharding.tree_leaves_with_path(padded):
        old = cache
        for k in path:
            old = old[k]
        if "mamba" in path or "cross" in path or path[-1] not in ("k", "v"):
            assert leaf.shape == old.shape, path
        else:
            assert leaf.shape[leaf.ndim - 3] == pos + 7, path
            assert torch.equal(leaf.narrow(leaf.ndim - 3, 0, pos), old)


def test_init_params_laws_and_determinism():
    _, cfg = reduced("mamba2-130m")
    a = api.init_params(cfg, 0, device="cpu")
    b = api.init_params(cfg, 0, device="cpu")
    c = api.init_params(cfg, 1, device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed.tok"], pc["embed.tok"])
    blk = a.groups["blocks"][0]
    assert (blk.ssm.D == 1).all() and (blk.ssm.A_log == 0).all() and (blk.ln1.scale == 0).all()
    assert abs(float(a.embed.tok.std()) - 0.02) < 2e-3  # "normal": 0.02
    # "scaled": the fan-in is every leading dim of the reference's leaf,
    # its stacked layer axis included (n_layers x d_model for wx)
    wx = torch.stack([g.ssm.wx for g in a.groups["blocks"]])
    assert abs(float(wx.std()) * (cfg.n_layers * cfg.d_model) ** 0.5 - 1.0) < 0.05
    # a leaf's values do not depend on the other leaves: its path seeds it
    tree = sharding.tree_init({"x": {"w": sharding.PD((4, 4), (None, None), "normal")}}, 0,
                              device="cpu")
    alone = sharding.tree_init({"x": {"w": sharding.PD((4, 4), (None, None), "normal")},
                                "y": sharding.PD((3,), (None,), "normal")}, 0, device="cpu")
    assert torch.equal(tree["x"]["w"], alone["x"]["w"])


def test_from_reference_refuses_wrong_trees():
    _, cfg = reduced("qwen3-1.7b")
    good = to_numpy(ref_params("qwen3-1.7b"))
    wrong_shape = {**good, "embed": {"tok": good["embed"]["tok"][:, :64]}}
    with pytest.raises(ValueError, match="embed/tok"):
        api.from_reference(cfg, wrong_shape, device="cpu")
    groups = {"blocks": {k: v for k, v in good["groups"]["blocks"].items() if k != "mlp"}}
    with pytest.raises(ValueError, match="lacks leaves.*mlp"):
        api.from_reference(cfg, {**good, "groups": groups}, device="cpu")
    with pytest.raises(ValueError, match="has leaf 'head'"):
        api.from_reference(cfg, {**good, "head": np.zeros((128, 512), np.float32)},
                           device="cpu")
    olmo = reduced("olmo-1b")[1]  # another config's tree: non-parametric norms
    with pytest.raises(ValueError, match="has leaf"):
        api.from_reference(olmo, good, device="cpu")
    # a stack of the wrong depth
    deep = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="wants"):
        api.from_reference(deep, good, device="cpu")


def test_entry_points_refuse_without_a_card(monkeypatch):
    """The default device is the card; with none there, every entry point
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = reduced("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.from_reference(cfg, to_numpy(ref_params("qwen3-1.7b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--new", "2"])


@pytest.mark.parametrize("arch", ["olmo-1b", "internvl2-26b", "whisper-medium"])
def test_serve_lm_cli_on_the_cpu(arch, capsys):
    assert serve_lm.main(["--arch", arch, "--batch", "2", "--prompt-len", "12", "--new", "4",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke: generated 8 tokens" in out and "device cpu" in out
    assert "sample token ids: [" in out
