"""The port's butterfly train step on 8 simulated ranks against the JAX
package's ``build_train_step_butterfly`` on ``mesh8`` (the reference's
``test_grad_sync_backends_agree`` and ``test_int8_compressed_sync_trains``,
at steps where ``lr > 0``): loss within 1e-4, parameters within rtol 2e-3,
atol 2e-4 after 3 steps (the reference tests' tolerances), by every
method; with the int8 wire, the loss within 1e-4 and the parameters within
a relative L1 of 0.02 of both the reference's int8 step and its one-device
step (the reference test's measure); the bytes each rank sent equal to the byte
model; the ranks' copies bit-identical where the fold order is the same on
every rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.dist.sharding import rules_for_mesh as ref_rules_for_mesh
from repro.train import optim as ref_optim, step as ref_step
from repro_torch.core import collectives
from repro_torch.dist.sharding import MeshRules, SimMesh, rules_for_mesh, sorted_leaves
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod
from test_torch_train_common import (LR_KW, STEPS, as_jax, as_torch, assert_trees_close,
                                     lm_batch, numpy_tree, port_model, ref_init, tiny)

# (method, fanout, compress); the reference's run each is held against (the
# same sum: fanout 4 and xla_psum against its fanout-2 butterfly, one compile
# fewer each)
CASES = {"butterfly": ("butterfly", 2, None), "butterfly-f4": ("butterfly", 4, None),
         "rabenseifner": ("rabenseifner", 2, None), "all_to_all": ("all_to_all", 2, None),
         "xla_psum": ("xla_psum", 2, None), "int8": ("butterfly", 2, "int8")}
REFERENCE = {"butterfly-f4": "butterfly", "xla_psum": "butterfly"}
# every rank folds the same sums in the same order (fanout 2: a + b == b + a;
# Rabenseifner: each chunk is reduced once); the int8 wire quantizes each
# rank's own accumulator, so its ranks differ by the quantization
SAME_ON_EVERY_RANK = ("butterfly", "rabenseifner")


@functools.lru_cache(maxsize=None)
def reference_run(case, mesh):
    """The reference's parameters and losses after ``STEPS`` of ``tiny()``
    from its seed-0 weights: the butterfly step of ``case`` (None: the
    one-device step)."""
    ref_cfg, cfg = tiny()
    params, batch = ref_init(ref_cfg), lm_batch(cfg.vocab, 8, 32)
    kw = {}
    if case:
        method, fanout, compress = CASES[case]
        kw = dict(method=method, fanout=fanout, compress=compress)
    rules = ref_rules_for_mesh(mesh, fsdp=False)
    fn = jax.jit(ref_step.build_train_step_butterfly(ref_cfg, mesh, rules, lr_kw=LR_KW, **kw)
                 if kw else ref_step.build_train_step(ref_cfg, mesh=mesh, rules=rules,
                                                      lr_kw=LR_KW))
    p, st = params, ref_optim.ADAMW.init(params)
    losses = []
    for s in STEPS:
        p, st, m = fn(p, st, as_jax(batch), jnp.int32(s))
        losses.append(float(m["loss"]))
    return p, losses


@pytest.mark.parametrize("case", list(CASES))
def test_butterfly_step_matches_reference(mesh8, case):
    method, fanout, compress = CASES[case]
    ref_cfg, cfg = tiny()
    params = ref_init(ref_cfg)
    batch = lm_batch(cfg.vocab, 8, 32)
    want, want_losses = reference_run(REFERENCE.get(case, case), mesh8)
    mesh = SimMesh(8)
    fn = step_mod.build_train_step_butterfly(cfg, mesh, rules_for_mesh(mesh), method=method,
                                             fanout=fanout, compress=compress, lr_kw=LR_KW)
    model = port_model(cfg, params)
    state = optim.ADAMW.init(model)
    n = [g.size for _, g in sorted_leaves(numpy_tree(api.to_reference(model)))]
    for s, want_loss in zip(STEPS, want_losses):
        model, state, m = fn(model, state, as_torch(batch), s)
        assert abs(float(m["loss"]) - want_loss) < 1e-4
        assert m["bytes_per_rank"] == sum(
            collectives.grad_sync_bytes(method, 8, fanout, k, 4, compress) for k in n)
        if case in SAME_ON_EVERY_RANK:
            assert float(m["rank_spread"]) == 0.0, case
        elif not compress:  # float32 sums in another order on each rank
            assert 0 < float(m["rank_spread"]) < 1e-6, case
    got = api.to_reference(model)
    if not compress:
        assert_trees_close(got, want, 2e-3, 2e-4, case)
        return
    # the int8 codes are a step function of the gradients: a float32 rounding
    # between the packages can flip a code at a rounding boundary and move
    # that element by a whole quantization step, so the int8 step is held by
    # tests/test_train.py::test_int8_compressed_sync_trains's measure, the
    # relative L1 distance, to the reference's int8 step and to its
    # one-device step
    one, _ = reference_run(None, mesh8)
    for label, ref in (("int8", want), ("one-device", one)):
        num = den = 0.0
        for (_, a), (_, b) in zip(sorted_leaves(jax.tree.map(np.asarray, ref)),
                                  sorted_leaves(got)):
            num += float(np.abs(a - b).sum())
            den += float(np.abs(a).sum()) + 1e-9
        assert num / den < 0.02, (label, num / den)


def test_butterfly_step_refuses_fsdp():
    _, cfg = tiny()
    with pytest.raises(ValueError, match="non-FSDP"):
        step_mod.build_train_step_butterfly(cfg, SimMesh(8), MeshRules(batch=("data",),
                                                                      fsdp=("data",)))
    assert rules_for_mesh(SimMesh(8), fsdp=True).fsdp == ("data",)
    assert rules_for_mesh(SimMesh(8)) == MeshRules(batch=("data",))
