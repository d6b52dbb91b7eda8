"""PyTorch port, the LM side's descriptors for all ten FULL configs: the
configs themselves, ``layer_groups``, ``param_defs``, ``cache_defs`` and
``input_defs`` at every shape, ``param_counts`` and ``model_flops`` equal to
the JAX package's. Descriptors only: nothing is allocated.
"""

import dataclasses

import pytest

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import api, lm
from test_torch_lm_common import ARCHS


def pd_tree(tree):
    """A PD tree of either package as plain tuples, comparable across them."""
    if isinstance(tree, dict):
        return {k: pd_tree(v) for k, v in tree.items()}
    return (tree.shape, tree.logical, tree.init, tree.dtype)


def prop(cfg, name):
    """A derived size, or the error it raises (mamba2 has no attention heads)."""
    try:
        return getattr(cfg, name)
    except ZeroDivisionError as e:
        return type(e)


def both(arch, **changes):
    return (dataclasses.replace(ref_configs.get_config(arch), **changes),
            dataclasses.replace(configs.get_config(arch), **changes))


def test_registry_and_shapes():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ref, cfg = both(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(cfg)) == dataclasses.asdict(
        ref_configs.reduced(ref))
    for name in ("resolved_head_dim", "padded_vocab", "d_inner", "n_ssm_heads"):
        assert prop(cfg, name) == prop(ref, name), name
    for i in range(cfg.n_layers):
        assert (cfg.is_moe_layer(i), cfg.is_attn_layer(i), cfg.is_global_attn_layer(i)) == (
            ref.is_moe_layer(i), ref.is_attn_layer(i), ref.is_global_attn_layer(i))
    for shape in base.SHAPES.values():
        assert base.shape_supported(cfg, shape) == ref_base.shape_supported(
            ref, ref_base.SHAPES[shape.name])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_reference(arch):
    ref, cfg = both(arch)
    if cfg.family != "audio":
        assert lm.layer_groups(cfg) == ref_lm.layer_groups(ref)
    assert pd_tree(api.param_defs(cfg)) == pd_tree(ref_api.param_defs(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_defs_match_reference(arch):
    ref, cfg = both(arch)
    variants = [{}]
    if cfg.local_window:
        variants.append({"ring_local_cache": True})
    for changes in variants:
        r, c = both(arch, **changes)
        for name, shape in base.SHAPES.items():
            rshape = ref_base.SHAPES[name]
            assert pd_tree(api.cache_defs(c, shape)) == pd_tree(ref_api.cache_defs(r, rshape))
            assert pd_tree(api.input_defs(c, shape)) == pd_tree(ref_api.input_defs(r, rshape))


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_flops_match_reference(arch):
    ref, cfg = both(arch)
    assert api.param_counts(cfg) == ref_api.param_counts(ref)
    for name, shape in base.SHAPES.items():
        assert api.model_flops(cfg, shape) == ref_api.model_flops(ref, ref_base.SHAPES[name])


def test_published_sizes_of_the_chip_configs():
    """The two configs served at full size on the card (``chip_smoke.py``)."""
    q = configs.get_config("qwen3-1.7b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.resolved_head_dim, q.d_ff,
            q.vocab, q.padded_vocab) == (28, 2048, 16, 8, 128, 6144, 151936, 152064)
    assert api.param_counts(q)["total"] == 1_720_837_120
    m = configs.get_config("mamba2-130m")
    assert (m.n_layers, m.d_model, m.ssm_state, m.ssm_head_dim, m.ssm_chunk) == (
        24, 768, 128, 64, 256)
    assert api.param_counts(m)["total"] == 129_057_216

