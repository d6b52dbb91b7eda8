"""Fault-tolerant training loop: checkpoint/restart, straggler detection,
simulated failures (the port of ``repro.train.loop``).

* restart: on startup, restore the latest checkpoint if present and resume
  at its step; the data pipeline is a pure function of step (deterministic
  skip), so no data state is saved.
* straggler mitigation: per-step wall times (ending in a synchronize on
  the card) feed an EWMA; steps slower than ``straggler_factor`` x the EWMA
  are logged as stragglers.
* simulated failure: ``fail_at_step`` raises mid-run; a restarted loop
  continues bit for bit as an uninterrupted one.

``grad_sync="xla"`` trains the whole batch on one device
(``build_train_step``); any other value is the butterfly step's method over
``ranks`` simulated ranks. Given ``comm``, a ``DistCommunicator``, the
loop runs one rank a process: the butterfly step over the process group
(``"xla"`` becomes its ``xla_psum``), every process restoring from the
checkpoint and rank 0 alone writing it and printing.

Given a ``mesh`` with a model axis, the model is sharded over it and
trains tensor-parallel: ``"xla"`` is the GSPMD step, any other method the
butterfly step with the model axis inside, on simulated ranks or, with
``comm`` (a ``DistCommunicator`` of ``mesh``), one rank a process. Its
checkpoint is the unsharded run's file (every process gathers the shards,
rank 0 writes), and a restore shards it again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bfs import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as shd
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 50
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    async_ckpt: bool = True
    fail_at_step: Optional[int] = None  # simulate a node failure
    straggler_factor: float = 3.0
    log_every: int = 10
    microbatches: int = 1
    grad_sync: str = "xla"  # xla | xla_psum | butterfly | rabenseifner | all_to_all
    fanout: int = 2
    lr_kw: Optional[Dict] = None


class SimulatedFailure(RuntimeError):
    pass


def train(
    cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    loop: LoopConfig = LoopConfig(),
    *,
    ranks: int = 1,
    rules: Optional[shd.MeshRules] = None,
    seed: int = 0,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
    device="cuda",
    comm=None,
    mesh: Optional[shd.SimMesh] = None,
) -> Dict:
    """Train ``loop.n_steps`` steps on ``device`` (the card by default;
    raises when there is none). Returns the model under "params", the
    optimizer state, the losses and the final step."""
    dev = resolve_device(device)
    opt = optim.get(cfg.optimizer)
    data = SyntheticLM(cfg, batch_size, seq_len)
    lead = comm is None or comm.rank == 0
    rules = rules or (shd.rules_for_mesh(mesh) if mesh is not None else None)
    if mesh is None and rules is not None and rules.fsdp:  # FSDP over the ranks
        mesh = shd.SimMesh(ranks) if comm is None else comm.mesh
    tp, fs = api.sharding_of(rules, mesh, dev, comm)
    if (tp is not None or fs is not None) and loop.grad_sync == "xla":
        # the GSPMD step: tensor-parallel over the model axis and, with FSDP
        # rules, FSDP over the data axes (never the unsharded path)
        fn = step_mod.build_train_step(cfg, mesh=mesh, rules=rules,
                                       microbatches=loop.microbatches, lr_kw=loop.lr_kw)
    elif tp is not None:
        fn = step_mod.build_train_step_butterfly(
            cfg, mesh, rules, method=loop.grad_sync, fanout=loop.fanout,
            microbatches=loop.microbatches, lr_kw=loop.lr_kw, comm=comm)
    elif loop.grad_sync == "xla" and comm is None:
        fn = step_mod.build_train_step(cfg, microbatches=loop.microbatches,
                                       lr_kw=loop.lr_kw)
    else:
        mesh = shd.SimMesh(ranks) if comm is None else comm.mesh
        fn = step_mod.build_train_step_butterfly(
            cfg, mesh, rules or shd.rules_for_mesh(mesh),
            method="xla_psum" if loop.grad_sync == "xla" else loop.grad_sync,
            fanout=loop.fanout, microbatches=loop.microbatches, lr_kw=loop.lr_kw, comm=comm,
        )

    start = 0
    model = opt_state = None
    if loop.ckpt_dir and ckpt.latest_step(loop.ckpt_dir) is not None:
        start, trees = ckpt.restore(
            loop.ckpt_dir,
            {"params": api.build_model(cfg, dev, tp, fs),
             "opt_state": opt.state_defs(api.param_defs(cfg))},
            device=dev,
        )
        model = trees["params"]
        opt_state = optim.local_state(model, trees["opt_state"])
        if lead:
            print(f"[restart] resumed from step {start}")
    if model is None:
        model = (api.init_params(cfg, seed, device=dev) if tp is None and fs is None else
                 api.init_params(cfg, seed, device=dev, rules=rules, mesh=mesh, comm=comm))
        opt_state = opt.init(model)

    ewma = None
    losses: List[float] = []
    pending = None
    for step in range(start, loop.n_steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise SimulatedFailure(f"simulated node failure at step {step}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        model, opt_state, metrics = fn(model, opt_state, batch, step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        loss = float(metrics["loss"])
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        straggler = step > start + 2 and dt > loop.straggler_factor * ewma
        losses.append(loss)
        if on_metrics:
            on_metrics(step, {**{k: float(v) for k, v in metrics.items()},
                              "step_time": dt, "straggler": straggler})
        if straggler and lead:
            print(f"[straggler] step {step}: {dt:.2f}s vs ewma {ewma:.2f}s")
        if step % loop.log_every == 0 and lead:
            print(f"step {step:5d} loss {loss:.4f} ({dt:.2f}s)")
        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            trees = {"params": model, "opt_state": opt_state}
            if tp is not None or fs is not None:  # every process gathers the shards
                trees = {"params": api.to_reference(model),
                         "opt_state": optim.global_state(model, opt_state)}
            if lead:
                if pending is not None:
                    pending.join()  # one in-flight async save at a time
                pending = ckpt.save(loop.ckpt_dir, step + 1, trees,
                                    async_=loop.async_ckpt, meta={"arch": cfg.name})
    if pending is not None:
        pending.join()
    return {"params": model, "opt_state": opt_state, "losses": losses,
            "final_step": loop.n_steps}
