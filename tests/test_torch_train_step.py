"""The port's one-device train step (``build_train_step``) against the JAX
package's, with microbatches 1 and 4: the same weights, batch and lr
schedule, 3 steps at ``lr > 0`` (the reference's own step tests compare
at step 0, where ``cosine_lr`` is 0 and nothing moves). Loss within 1e-5,
parameters within rtol 1e-5, atol 1e-6, the moments as close as the
gradients (rtol 1e-4; the second moment 2e-4); the gradient
dtypes of each path; microbatching against the full batch in the port.
Where a gradient is within 100x of AdamW's eps, the update is
ill-conditioned and those few elements are held to the update's bound
(``assert_adam_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as ref_api
from repro.train import optim as ref_optim, step as ref_step
from repro_torch.dist.sharding import sorted_leaves
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod
from test_torch_lm_common import to_numpy
from test_torch_train_common import (LR_KW, STEPS, as_jax, as_torch, assert_adam_close,
                                     assert_trees_close, lm_batch, port_model, ref_init, tiny)


def run_port(cfg, params, batch, microbatches):
    model = port_model(cfg, params)
    state = optim.ADAMW.init(model)
    fn = step_mod.build_train_step(cfg, microbatches=microbatches, lr_kw=LR_KW)
    losses = []
    for s in STEPS:
        model, state, m = fn(model, state, as_torch(batch), s)
        losses.append(float(m["loss"]))
    return model, state, losses, m


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(microbatches):
    ref_cfg, cfg = tiny()
    params = ref_init(ref_cfg, 1)
    batch = lm_batch(cfg.vocab, 8, 32, seed=1)
    fn = jax.jit(ref_step.build_train_step(ref_cfg, microbatches=microbatches, lr_kw=LR_KW))
    grads_of = jax.jit(lambda p: ref_step._grads_of(ref_api.train_loss_fn(ref_cfg), p,
                                                    as_jax(batch), microbatches)[1])
    p, st = params, ref_optim.ADAMW.init(params)
    want, grads = [], []
    for s in STEPS:
        grads.append(grads_of(p))
        p, st, m = fn(p, st, as_jax(batch), jnp.int32(s))
        want.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    model, state, losses, last = run_port(cfg, params, batch, microbatches)
    for (loss, gn, lr), got in zip(want, losses):
        assert abs(got - loss) <= 1e-5, (got, loss)
    assert float(last["grad_norm"]) == pytest.approx(want[-1][1], rel=1e-5)
    assert last["lr"] == pytest.approx(want[-1][2], rel=1e-6) and last["lr"] > 0
    lr_sum = sum(lr for _, _, lr in want)
    assert_adam_close(api.to_reference(model), p, grads, lr_sum, 1e-5, 1e-6, "params")
    # the moments are linear and quadratic in the gradients, which agree to
    # rtol 1e-4 (test_torch_train_grads.py)
    assert_trees_close(state["m"], st["m"], 1e-4, 1e-7, "m")
    assert_trees_close(state["v"], st["v"], 2e-4, 1e-12, "v")
    assert int(state["count"]) == len(STEPS)


def test_microbatching_matches_full_batch():
    """tests/test_train.py's check on the port, at steps where lr > 0."""
    ref_cfg, cfg = tiny()
    params = ref_init(ref_cfg, 1)
    batch = lm_batch(cfg.vocab, 8, 32, seed=1)
    m1, _, l1, _ = run_port(cfg, params, batch, 1)
    m4, _, l4, _ = run_port(cfg, params, batch, 4)
    assert all(abs(a - b) < 1e-3 for a, b in zip(l1, l4))
    assert_trees_close(api.to_reference(m4), to_numpy(api.to_reference(m1)), 5e-3, 5e-4)


def test_grad_dtypes_follow_the_reference():
    """microbatches == 1: the parameter dtype; more: the accumulator dtype."""
    ref_cfg, cfg = tiny(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = ref_init(ref_cfg)
    batch = lm_batch(cfg.vocab, 4, 16)
    model = port_model(cfg, params)
    for mb in (1, 2):
        _, want = jax.jit(lambda p, b, mb=mb: ref_step._grads_of(
            ref_api.train_loss_fn(ref_cfg), p, b, mb))(params, as_jax(batch))
        _, got = step_mod._grads_of(api.train_loss_fn(cfg), model, as_torch(batch), mb,
                                    torch.float32)
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        for (path, g), (_, w) in zip(sorted_leaves(got),
                                     sorted_leaves(jax.tree.map(np.asarray, want))):
            assert g.dtype == dt[str(w.dtype)], (mb, path, g.dtype, w.dtype)
    assert not any(p.requires_grad for p in model.parameters())
