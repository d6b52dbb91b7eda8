"""The port's optimizers against the JAX package's (``repro.train.optim``):
AdamW and Adafactor ``apply`` over 3 steps on the same parameters, gradients
and state (float32 on the CPU; rtol 1e-6, atol 1e-7), on ``_tiny()`` and
on reduced kimi-k2 (Adafactor's config), Adafactor on the reference's
stacked leaves; the state descriptors, ``cosine_lr``,
``clip_by_global_norm`` and the textbook AdamW scalar step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.train import optim as ref_optim
from repro_torch import configs
from repro_torch.dist.sharding import sorted_leaves
from repro_torch.models import api
from repro_torch.train import optim
from test_torch_lm_common import to_numpy
from test_torch_train_common import (LR_KW, STEPS, assert_trees_close, numpy_tree, port_model,
                                     reduced, ref_init, tiny)

RTOL, ATOL = 1e-6, 1e-7


def rand_grads(params, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), params)


def tree_torch(tree):
    return {k: tree_torch(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(np.array(tree))


CASES = {
    "adamw-tiny": lambda: tiny(optimizer="adamw"),
    "adafactor-tiny": lambda: tiny(optimizer="adafactor"),
    "adafactor-kimi": lambda: reduced("kimi-k2-1t-a32b"),
    "adamw-kimi": lambda: reduced("kimi-k2-1t-a32b", optimizer="adamw"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_reference(case):
    ref_cfg, cfg = CASES[case]()
    assert cfg.optimizer == case.split("-")[0]
    ref_opt, opt = ref_optim.get(cfg.optimizer), optim.get(cfg.optimizer)
    params = ref_init(ref_cfg)
    ref_state = ref_opt.init(params)
    model = port_model(cfg, params)
    state = optim.from_reference(model, to_numpy(ref_state))
    assert_trees_close(state, ref_state, 0, 0, "init")
    for s in STEPS:
        grads = rand_grads(params, s)
        lr = optim.cosine_lr(s, **LR_KW)
        params, ref_state = jax.jit(ref_opt.apply)(params, grads, ref_state, jnp.float32(lr))
        model, state = opt.apply(model, tree_torch(grads), state, lr)
        assert lr > 0
        assert_trees_close(api.to_reference(model), params, RTOL, ATOL, f"{case} step {s}")
        assert_trees_close(state, ref_state, RTOL, ATOL, f"{case} state step {s}")
    assert int(state["count"]) == len(STEPS)


def test_adafactor_state_is_stacked():
    """A per-layer norm scale, ``(d,)`` in the model, is one factored
    ``(n_layers, d)`` leaf of the state: ``vr`` over layers, ``vc`` over d."""
    _, cfg = tiny(optimizer="adafactor")
    model = api.init_params(cfg, 0, device="cpu")
    wq = model.groups["blocks"][0].attn.wq.shape
    st = optim.ADAFACTOR.init(model)["f"]["groups"]["blocks"]["attn"]["wq"]
    assert tuple(st["vr"].shape) == (cfg.n_layers,) + tuple(wq[:-1])
    assert tuple(st["vc"].shape) == (cfg.n_layers,) + tuple(wq[:-2]) + tuple(wq[-1:])
    _, qcfg = tiny("qwen3-1.7b", optimizer="adafactor")
    qst = optim.ADAFACTOR.init(api.init_params(qcfg, 0, device="cpu"))
    ln = qst["f"]["groups"]["blocks"]["ln1"]["scale"]
    assert set(ln) == {"vr", "vc"}
    assert tuple(ln["vr"].shape) == (qcfg.n_layers,) and tuple(ln["vc"].shape) == (qcfg.d_model,)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_state_defs_match_reference(arch, name):
    ref_defs = ref_optim.get(name).state_defs(
        ref_api.param_defs(ref_configs.reduced(ref_configs.get_config(arch))))
    defs = optim.get(name).state_defs(api.param_defs(configs.reduced(configs.get_config(arch))))
    is_pd = lambda x: hasattr(x, "logical")  # noqa: E731
    want = {tuple(getattr(k, "key", k) for k in path): pd
            for path, pd in jax.tree_util.tree_flatten_with_path(ref_defs, is_leaf=is_pd)[0]}
    got = dict(sorted_leaves(defs))
    assert list(got) == list(want)
    for path, pd in want.items():
        assert (got[path].shape, got[path].logical, got[path].init, got[path].dtype) == (
            pd.shape, pd.logical, pd.init, pd.dtype), path


def test_cosine_lr_matches_reference():
    for kw in ({}, LR_KW, {"peak": 1.0, "warmup": 10, "total": 100},
               {"peak": 3e-4, "warmup": 0, "total": 7, "floor": 0.0}):
        for s in (0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
            want = float(ref_optim.cosine_lr(jnp.int32(s), **kw))
            assert optim.cosine_lr(s, **kw) == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, s)
    # tests/test_train.py::test_cosine_lr_shape on the port
    lr0, lr10, lr100 = (optim.cosine_lr(s, peak=1.0, warmup=10, total=100) for s in (0, 10, 100))
    assert lr0 == 0.0 and abs(lr10 - 1.0) < 1e-6 and lr100 < 0.11


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    """Unclipped (norm < 1) and clipped (norm > 1): the norm and every leaf."""
    _, cfg = tiny()
    params = ref_init(tiny()[0])
    grads = rand_grads(params, 7, scale)
    want, want_norm = ref_optim.clip_by_global_norm(grads, 1.0)
    got, norm = optim.clip_by_global_norm(tree_torch(grads), 1.0)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
    assert (float(norm) > 1.0) == (scale > 1)
    assert_trees_close(got, want, RTOL, ATOL, "clipped")


def test_adamw_reference_step():
    """AdamW against the textbook update on a single scalar."""
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.tensor([2.0]), requires_grad=False)
    st = {"m": {"w": torch.zeros(1)}, "v": {"w": torch.zeros(1)},
          "count": torch.zeros((), dtype=torch.int32)}
    m, st2 = optim.ADAMW.apply(m, {"w": torch.tensor([0.5])}, st, 0.1)
    # t=1: mhat=g, vhat=g^2 -> step = g/|g| = 1; wd 0.1*2
    want = 2.0 - 0.1 * (0.5 / 0.5 + 0.1 * 2.0)
    np.testing.assert_allclose(m.w.numpy(), [want], rtol=1e-4)
    assert int(st2["count"]) == 1


def test_bfloat16_params_update_in_float32():
    """bfloat16 parameters: the update is computed in float32 and cast back,
    as the reference does; the results agree to one bfloat16 ulp (2**-8
    relative), nearly all bit for bit."""
    ref_cfg, cfg = tiny(param_dtype="bfloat16")
    params = ref_init(ref_cfg)
    ref_state = ref_optim.ADAMW.init(params)
    model = port_model(cfg, params)
    state = optim.from_reference(model, to_numpy(ref_state))
    assert model.embed.tok.dtype == torch.bfloat16
    for s in STEPS:
        grads = rand_grads(params, s)
        lr = optim.cosine_lr(s, **LR_KW)
        params, ref_state = ref_optim.ADAMW.apply(params, grads, ref_state, jnp.float32(lr))
        model, state = optim.ADAMW.apply(model, tree_torch(grads), state, lr)
    got = dict(sorted_leaves(numpy_tree(api.to_reference(model))))
    want = dict(sorted_leaves(to_numpy(params)))
    same = total = 0
    for path, w in want.items():
        assert got[path].dtype.str == "|V2"
        g16, w16 = got[path].view(np.int16), np.asarray(w).view(np.int16)
        same += int((g16 == w16).sum())
        total += w16.size
        gf = torch.from_numpy(g16.copy()).view(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(gf, np.asarray(w, np.float32), rtol=2 ** -8, atol=1e-7)
    assert same >= 0.999 * total, (same, total)
    assert_trees_close(state, ref_state, RTOL, ATOL, "bfloat16 state")


def test_from_reference_refuses_wrong_state():
    ref_cfg, cfg = tiny()
    params = ref_init(ref_cfg)
    model = port_model(cfg, params)
    state = to_numpy(ref_optim.ADAMW.init(params))
    with pytest.raises(ValueError, match="does not match"):
        optim.from_reference(model, to_numpy(ref_optim.ADAFACTOR.init(params)))
    state["m"]["embed"]["tok"] = state["m"]["embed"]["tok"][:, :8]
    with pytest.raises(ValueError, match="embed/tok"):
        optim.from_reference(model, state)
