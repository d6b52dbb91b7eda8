"""PyTorch port, every architecture at its reduced config: the full forward
(``forward_hidden``/``lm_logits``, whisper's ``encode`` and ``_decoder``) and
the ``train_loss`` value against the JAX package, and the port's own
prefill + teacher-forced decode against its full forward (the counterpart
of ``test_models.py::test_prefill_decode_matches_forward``).

Same weights (the reference's ``init_params``, carried by
``from_reference``) and seeded numpy inputs; float32 on the CPU, atol =
rtol = 1e-4.
"""

import numpy as np
import pytest
import torch

from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro_torch.models import api, encdec, lm
from repro_torch.serve import engine
from test_torch_lm_common import (ARCHS, as_jax, as_torch, assert_close, batch, port_model,
                             reduced, ref_params)


def full_logits(cfg, model, inputs):
    """The port's logits at every position of ``inputs``."""
    toks = inputs["tokens"]
    if cfg.family == "audio":
        enc = encdec.encode(cfg, model, inputs["frames"])
        h, _ = encdec._decoder(cfg, model, toks, enc)
    else:
        h = lm.forward_hidden(cfg, model, toks, patches=inputs.get("patches"))
    return lm.lm_logits(cfg, model, h)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg = reduced(arch)
    params, model = ref_params(arch), port_model(arch)
    bt = batch(cfg, 2, 32)
    inputs = {k: v for k, v in bt.items() if k != "labels"}
    t, j = as_torch(inputs), as_jax(inputs)
    if cfg.family == "audio":
        enc = encdec.encode(cfg, model, t["frames"])
        renc = ref_encdec.encode(ref_cfg, params, j["frames"])
        assert_close(enc, renc, what="encoder states")
        h, _ = encdec._decoder(cfg, model, t["tokens"], enc)
        rh, _ = ref_encdec._decoder(ref_cfg, params, j["tokens"], renc, rules=None,
                                    mesh=None)
    else:
        h = lm.forward_hidden(cfg, model, t["tokens"], patches=t.get("patches"))
        rh = ref_lm.forward_hidden(ref_cfg, params, j["tokens"], patches=j.get("patches"))
    assert tuple(h.shape) == tuple(rh.shape)
    assert_close(h, rh, what="final hidden")
    logits = lm.lm_logits(cfg, model, h)
    assert_close(logits, ref_lm.lm_logits(ref_cfg, params, rh), what="logits")
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    ref_cfg, cfg = reduced(arch)
    bt = batch(cfg, 2, 32, seed=3)
    bt["labels"][:, :3] = -1  # ignored positions
    got = api.train_loss_fn(cfg)(port_model(arch), as_torch(bt))
    want = ref_api.train_loss_fn(ref_cfg)(ref_params(arch), as_jax(bt))
    assert_close(got, want, what="loss")
    assert np.isfinite(float(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Teacher-forced decode through the port's cache reproduces the port's
    full-forward logits (and so the reference's)."""
    _, cfg = reduced(arch)
    model = port_model(arch)
    bt = batch(cfg, 2, 24)
    inputs = as_torch({k: v for k, v in bt.items() if k != "labels"})
    toks = inputs["tokens"]
    want = full_logits(cfg, model, inputs)
    cut = toks.shape[1] - 5
    logits, cache, pos = api.prefill_fn(cfg)(model, dict(inputs, tokens=toks[:, :cut]))
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    assert pos == prefix + cut
    cache = engine.pad_cache(cache, cut + prefix + 5)
    got = [logits]
    for i in range(4):
        logits, cache = api.decode_fn(cfg)(model, cache, toks[:, cut + i:cut + i + 1], pos + i)
        got.append(logits)
    assert_close(torch.stack(got, dim=1), want[:, prefix + cut - 1:prefix + cut + 4])

