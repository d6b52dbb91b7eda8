"""deepseek-7b's loss over ``chip_smoke.py``'s training schedule
(``TRAIN_LR``: peak 3e-4, warm-up 2, 8 steps in all; 3 steps of 8 rows in
the config's 4 microbatches), in the JAX package and in the port from the
same weights on the CPU. The test holds the port's losses to the
reference's at the reduced config; the shape of the curve is reported, not
held.

Run as a script, the same schedule at wider cuts of deepseek-7b (the
widths the reduced config leaves out, 2 layers, a cut vocabulary) in both
packages, one line a config; then gemma3-27b's first loss at its full
widths (one layer, a cut vocabulary) in both, from the same weights:

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/test_torch_loss_schedule.py

(the widest cut takes about 10 GB and two minutes)."""

import dataclasses
import sys

import jax
import numpy as np
import torch

import chip_smoke
from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.train.loop import LoopConfig as RefLoopConfig, train as ref_train
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.train.loop import LoopConfig, train
from test_torch_train_common import port_model, reduced, ref_init

STEPS, ROWS, SEQ, MICROBATCHES = 3, 8, 32, 4
# (d_model, d_ff, heads, vocab, tokens): the reduced config's other widths
# kept; head_dim 128 as published
WIDE = ((1024, 2752, 8, 102400, 128), (2048, 5504, 16, 102400, 128),
        (4096, 11008, 32, 16384, 128))


def schedule_losses(changes, seq=SEQ):
    """The losses of both packages over the schedule, the port from the
    reference's initial weights: ``(reference, port)``."""
    ref_cfg, cfg = reduced("deepseek-7b", **changes)
    kw = dict(n_steps=STEPS, log_every=1000, microbatches=MICROBATCHES,
              lr_kw=chip_smoke.TRAIN_LR)
    want = ref_train(ref_cfg, ROWS, seq, RefLoopConfig(**kw))["losses"]
    real = api.init_params
    api.init_params = lambda c, seed=0, *, device: port_model(c, ref_init(ref_cfg, seed))
    try:
        got = train(cfg, ROWS, seq, LoopConfig(**kw), device="cpu")["losses"]
    finally:
        api.init_params = real
    return want, got


def test_reduced_deepseek_losses_equal_the_reference_over_the_schedule(capsys):
    want, got = schedule_losses({})
    with capsys.disabled():
        print(f"\nreduced deepseek-7b over TRAIN_LR: reference {want}, port {got}")
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def first_loss(arch, **changes):
    """``arch``'s train loss on the first synthetic batch (2 x 64), float32,
    in both packages from the reference's weights: ``(reference, port)``."""
    kw = dict(changes, param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **kw)
    cfg = dataclasses.replace(configs.get_config(arch), **kw)
    params = ref_init(ref_cfg)
    batch = SyntheticLM(cfg, 2, 64).batch_at(0)
    want = float(ref_api.train_loss_fn(ref_cfg)(params, jax.tree.map(jax.numpy.asarray, batch)))
    model = port_model(cfg, params)
    got = float(api.train_loss_fn(cfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()}))
    return want, got


if __name__ == "__main__":
    for d, ff, heads, vocab, seq in WIDE:
        want, got = schedule_losses(dict(d_model=d, d_ff=ff, n_heads=heads, n_kv_heads=heads,
                                         head_dim=128, vocab=vocab, n_layers=2), seq)
        print(f"d_model {d}, d_ff {ff}, {heads} heads, vocab {vocab}, 2 layers, {ROWS} x {seq}: "
              f"reference {[round(x, 4) for x in want]}, port {[round(x, 4) for x in got]}",
              flush=True)
    want, got = first_loss("gemma3-27b", n_layers=1, vocab=4096)
    print(f"gemma3-27b, 1 layer, vocab 4096, 2 x 64: first loss reference {want:.4f}, port "
          f"{got:.4f} (ln 4096 = {np.log(4096):.4f})", flush=True)
    sys.exit(0)
