"""Shared helpers of the training parity tests (``test_torch_train_*.py``):
the same configs, weights, batches and optimizer states through the JAX
package and the port, on the CPU in float32.

The configs are the reference tests' ``_tiny()`` (``tests/test_train.py``,
``tests/test_checkpoint.py``) and ``configs.reduced``; weights are the
reference's ``init_params``, carried into the port by
``api.from_reference``; optimizer states by ``optim.from_reference``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.dist.sharding import sorted_leaves
from repro_torch.models import api
from test_torch_lm_common import to_numpy

# steps with lr > 0 (cosine_lr(0) == 0 under any warm-up)
LR_KW = {"peak": 1e-3, "warmup": 1, "total": 10}
STEPS = (1, 2, 3)
TINY = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32,
            vocab=256)


def tiny(arch="olmo-1b", **kw):
    """``_tiny()`` of the reference's training and checkpoint tests, in both
    packages."""
    ref = dataclasses.replace(ref_configs.reduced(ref_configs.get_config(arch)), **TINY, **kw)
    port = dataclasses.replace(configs.reduced(configs.get_config(arch)), **TINY, **kw)
    return ref, port


def reduced(arch, **kw):
    ref = dataclasses.replace(ref_configs.reduced(ref_configs.get_config(arch)), **kw)
    port = dataclasses.replace(configs.reduced(configs.get_config(arch)), **kw)
    return ref, port


def ref_init(ref_cfg, seed=0):
    return ref_api.init_params(ref_cfg, jax.random.PRNGKey(seed))


def port_model(cfg, ref_params):
    return api.from_reference(cfg, to_numpy(ref_params), device="cpu")


def lm_batch(vocab, rows=8, seq=32, seed=0):
    """``test_train.py``'s batch: seeded tokens and labels, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def numpy_tree(tree):
    """A tree of tensors or arrays as numpy (bfloat16 as ``|V2``)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return api.to_numpy(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)


def assert_trees_close(got, want, rtol, atol, what=""):
    """Two trees (port tensors or arrays, reference arrays) leaf for leaf, in
    the reference's leaf order: the same paths, shapes and values."""
    got = dict(sorted_leaves(numpy_tree(got)))
    want = dict(sorted_leaves(numpy_tree(want)))
    assert list(got) == list(want), (what, sorted(set(got) ^ set(want)))
    for path in want:
        assert got[path].shape == want[path].shape, (what, path)
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def assert_trees_equal(got, want, what=""):
    got = dict(sorted_leaves(numpy_tree(got)))
    want = dict(sorted_leaves(numpy_tree(want)))
    assert list(got) == list(want), (what, sorted(set(got) ^ set(want)))
    for path in want:
        a, b = got[path], want[path]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path, a.dtype, b.dtype)
        if a.dtype.kind == "V":  # bfloat16 bits
            a, b = a.view(np.int16), b.view(np.int16)
        assert np.array_equal(a, b), (what, "/".join(path))


# AdamW's eps (train/optim.py); a gradient within 100x of it makes the
# update g / (|g| + eps) ill-conditioned: two float32 gradients that differ
# by one rounding move it by a visible share of a whole step
ADAM_EPS = 1e-8
ILL_CONDITIONED = 100 * ADAM_EPS


def assert_adam_close(got, want, grads, lr_sum, rtol, atol, what=""):
    """Parameters after AdamW steps, leaf for leaf: within ``rtol``/``atol``,
    except where a step's gradient (``grads``: one tree a step) was nonzero
    and under ``ILL_CONDITIONED`` in magnitude: there within
    ``2 * lr_sum``, the most an update bounded by 1 in magnitude can move a
    parameter over the steps. Such elements must be under 1 % of the
    model; a zero gradient (a row no token reaches) moves alike anywhere."""
    got = dict(sorted_leaves(numpy_tree(got)))
    want = dict(sorted_leaves(numpy_tree(want)))
    small = {}
    for tree in grads:
        for path, g in sorted_leaves(numpy_tree(tree)):
            g = np.abs(np.asarray(g, np.float64))
            s = (g < ILL_CONDITIONED) & (g > 0)
            small[path] = s if path not in small else small[path] | s
    assert list(got) == list(want) == list(small), what
    for path, w in want.items():
        a, b, s = np.asarray(got[path], np.float64), np.asarray(w, np.float64), small[path]
        np.testing.assert_allclose(a[~s], b[~s], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")
        np.testing.assert_allclose(a[s], b[s], rtol=0, atol=2 * lr_sum,
                                   err_msg=f"{what} {'/'.join(path)} (|g| < {ILL_CONDITIONED})")
    n_small = sum(int(s.sum()) for s in small.values())
    assert n_small < 0.01 * sum(s.size for s in small.values()), (what, n_small)
