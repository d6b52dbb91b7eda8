"""Shared fixtures of the LM parity tests (``test_torch_lm_*.py``): the same
seeded inputs and weights through the JAX package and the port, on the CPU.

Weights are the reference's ``init_params`` (``jax.random``), carried into
the port by ``api.from_reference``; inputs are numpy draws from a seed.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.models import api

ARCHS = configs.ARCH_NAMES
# float32 on the CPU, the same math in both packages: agreement to rounding
# (whole models; single blocks to TOL)
ATOL = RTOL = 1e-4
TOL = dict(atol=1e-5, rtol=1e-5)


def reduced(arch: str, **changes):
    """The reduced config of ``arch`` in both packages (equal field for field)."""
    ref = dataclasses.replace(ref_configs.reduced(ref_configs.get_config(arch)), **changes)
    port = dataclasses.replace(configs.reduced(configs.get_config(arch)), **changes)
    return ref, port


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    ref_cfg, _ = reduced(arch)
    return ref_api.init_params(ref_cfg, jax.random.PRNGKey(0))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_model(arch: str, cfg=None):
    """The port's model of ``arch`` carrying the reference's weights."""
    cfg = cfg or reduced(arch)[1]
    return api.from_reference(cfg, to_numpy(ref_params(arch)), device="cpu")


def batch(cfg, b=2, l=32, seed=0):
    """``tests/test_models.py::_batch`` as numpy: tokens, labels, frames or
    patches."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab, (b, l)).astype(np.int32)
    elif cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab, (b, l - cfg.n_patches)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, l)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, out["tokens"].shape).astype(np.int32)
    return out


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def assert_close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def assert_tree_close(got, want, atol=ATOL, rtol=RTOL, path=""):
    """Two caches leaf for leaf: the same keys, shapes and values."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_tree_close(got[k], want[k], atol, rtol, f"{path}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), (path, got.shape, want.shape)
    assert_close(got, want, atol, rtol, path)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def rand_tree(defs, seed, scale=0.1):
    """numpy normal draws for every leaf of a PD dict."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    return {k: rand_tree(v, rng, scale) if isinstance(v, dict)
            else (rng.normal(size=v.shape) * scale).astype(np.float32)
            for k, v in defs.items()}


def jtree(tree):
    return {k: jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def x_of(shape, seed=1):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x.copy())
