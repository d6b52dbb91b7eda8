"""The port's training loop and launcher: the reference's loop tests on the
port (the loss decreases, the straggler hook), the loop against the JAX
package's with the same initial weights (the port's ``api.init_params``
handed the reference's, its seeded draws not being ``jax.random``'s), the
``launch.train`` CLI on the CPU, and the card as every entry point's
default, refused when there is none, never replaced by the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from repro.dist.sharding import rules_for_mesh as ref_rules_for_mesh
from repro.train.loop import LoopConfig as RefLoopConfig, train as ref_train
from repro_torch.checkpoint import ckpt
from repro_torch.dist import sharding
from repro_torch.launch import train as train_cli
from repro_torch.models import api, lm
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, train
from test_torch_train_common import (LR_KW, as_torch, assert_trees_close, lm_batch,
                                     port_model, ref_init, tiny)


def test_loss_decreases():
    _, cfg = tiny()
    out = train(cfg, 8, 64, loop=LoopConfig(n_steps=30, ckpt_dir=None, log_every=1000,
                                            lr_kw={"peak": 1e-2, "warmup": 5, "total": 30}),
                device="cpu")
    losses = out["losses"]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_straggler_detection_hook():
    _, cfg = tiny()
    events = []
    train(cfg, 4, 32, loop=LoopConfig(n_steps=6, log_every=1000),
          on_metrics=lambda s, m: events.append(m), device="cpu")
    assert len(events) == 6
    assert all("step_time" in e and "straggler" in e for e in events)
    assert all(isinstance(e["loss"], float) and e["lr"] >= 0 for e in events)


@pytest.mark.parametrize("grad_sync", ["xla", "butterfly"])
def test_loop_matches_reference(grad_sync, mesh8, monkeypatch):
    """Five steps of the same stream from the same weights: each loss within
    1e-5; the parameters within the reference's cross-backend tolerance
    (rtol 2e-3, atol 2e-4: an element whose gradient is near AdamW's eps
    can move by a share of a step between two float32 gradients)."""
    ref_cfg, cfg = tiny()
    kw = dict(n_steps=5, log_every=1000, grad_sync=grad_sync, lr_kw=LR_KW)
    extra = {}
    if grad_sync != "xla":
        extra = dict(mesh=mesh8, rules=ref_rules_for_mesh(mesh8))
    want = ref_train(ref_cfg, 8, 32, RefLoopConfig(**kw), **extra)
    monkeypatch.setattr(api, "init_params",
                        lambda c, seed=0, *, device: port_model(c, ref_init(ref_cfg, seed)))
    got = train(cfg, 8, 32, LoopConfig(**kw), ranks=8, device="cpu")
    assert len(got["losses"]) == 5
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
    assert_trees_close(api.to_reference(got["params"]),
                       jax.tree.map(np.asarray, want["params"]), 2e-3, 2e-4)


@pytest.mark.parametrize("extra", [[], ["--grad-sync", "butterfly", "--ranks", "4"],
                                   ["--arch", "whisper-medium"]])
def test_train_cli_on_the_cpu(extra, capsys, tmp_path):
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--device", "cpu"]
    assert train_cli.main(argv + extra) == 0
    out = capsys.readouterr().out
    assert "done: first loss" in out and "step     0 loss" in out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2


def test_entry_points_refuse_without_a_card(monkeypatch):
    """The card is the default; with none there, each entry point raises
    instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = tiny()
    defs = {"x": sharding.PD((4,), (None,), "normal")}
    for call in (lambda: sharding.tree_init(defs, 0),
                 lambda: list(sharding.iter_init(defs, 0)),
                 lambda: train(cfg, 4, 32, LoopConfig(n_steps=1)),
                 lambda: ckpt.restore("nowhere", {}),
                 lambda: train_cli.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert sharding.tree_init(defs, 0, device="cpu")["x"].device.type == "cpu"


def test_training_leaves_serving_without_a_graph():
    """A train step turns gradients on for itself only: afterwards the
    parameters record nothing and a forward pass builds no graph."""
    ref_cfg, cfg = tiny()
    model = port_model(cfg, ref_init(ref_cfg))
    state = optim.ADAMW.init(model)
    batch = as_torch(lm_batch(cfg.vocab, 4, 16))
    step_mod.build_train_step(cfg, lr_kw=LR_KW)(model, state, batch, 1)
    assert not any(p.requires_grad for p in model.parameters())
    assert lm.forward_hidden(cfg, model, batch["tokens"]).grad_fn is None
