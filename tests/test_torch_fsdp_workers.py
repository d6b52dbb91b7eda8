"""The processes of ``test_torch_fsdp_dist.py``: what each rank of a
4-process gloo group runs, importable without JAX (a spawned process
imports this module to find its function). No tests here.

Each rank builds a reduced config with FSDP rules through a
``DistCommunicator`` and takes one GSPMD train step of the global batch:
reduced deepseek-7b (AdamW) on (data 2, model 2) and reduced qwen3-moe
(Adafactor) on data 4. It saves what it holds of each split leaf, the
step's metrics, the gathered parameters and optimizer state, and its FSDP
and model-axis records.

Run as a script (``torchrun ... tests/test_torch_fsdp_workers.py
<launch.train flags>``) it is ``repro_torch.launch.train`` with each
config's FSDP kept by ``--smoke`` (the reduced config drops it), and
prints each rank's held share of the split leaves.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.dist.process import DistCommunicator
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod

WORLD = 4
CASES = {"deepseek-7b": SimMesh((2, 2), ("data", "model")),
         "qwen3-moe-235b-a22b": SimMesh(4)}
BATCH, SEQ = 4, 16
LR_KW = {"peak": 1e-3, "warmup": 1, "total": 10}


def cfg_of(arch):
    return configs.reduced(configs.get_config(arch))


def batch_of(c):
    """The global batch, from a seed."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, c.vocab, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _stats(par):
    return None if par is None else {k: dict(v) for k, v in par.stats.items()}


def run(comm, arch):
    """One FSDP GSPMD step of ``arch`` on its mesh, over ``comm`` (a
    ``DistCommunicator``, or simulated ranks)."""
    c, mesh = cfg_of(arch), CASES[arch]
    rules = rules_for_mesh(mesh, fsdp=True)
    model = api.init_params(c, 0, device="cpu", rules=rules, mesh=mesh, comm=comm)
    # what this program holds of each split leaf, and over how many ranks
    held = {"/".join(path): (sum(p.numel() for p in ps),
                             model.fsdp.size * (model.tp.size if ps[0].tp_dim is not None
                                                else 1))
            for path, _, ps in api.param_leaves(model) if ps[0].fsdp_dim is not None}
    grads = None
    if not isinstance(comm, DistCommunicator):  # the whole gradient, for AdamW's bound
        grads = api.global_leaves(model, step_mod._grads_of(
            api.train_loss_fn(c, rules, mesh), model, batch_of(c), 1)[1])
        for par in (model.fsdp, model.tp):
            if par is not None:
                par.reset()
    state = optim.get(c.optimizer).init(model)
    fn = step_mod.build_train_step(c, mesh=mesh, rules=rules, lr_kw=LR_KW)
    model, state, m = fn(model, state, batch_of(c), 1)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
            "held": held, "params": api.to_reference(model), "grads": grads,
            "state": {"/".join(p): v.clone() for p, v in
                      _leaves(optim.global_state(model, state))},
            "fsdp_stats": _stats(model.fsdp), "tp_stats": _stats(model.tp),
            "bytes": int(model.fsdp.bytes_sent[0])}


def fsdp_group_checks(rank, world, out_dir):
    torch.set_num_threads(1)  # four processes on the host's cores
    out = {arch: run(DistCommunicator("cpu", mesh), arch) for arch, mesh in CASES.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def launch(argv):
    """``launch.train.main(argv)`` with FSDP kept by ``--smoke``; each rank
    prints the share of the split leaves it holds."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop

    reduced = configs.reduced
    configs.reduced = lambda c: dataclasses.replace(reduced(c), fsdp=c.fsdp)
    real = loop.train

    def spy(*a, **kw):
        out = real(*a, **kw)
        model, comm = out["params"], kw.get("comm")
        held = [p.numel() for _, _, ps in api.param_leaves(model) for p in ps
                if getattr(p, "fsdp_dim", None) is not None]
        print(f"fsdp rank {comm.rank if comm is not None else 0}: "
              f"{model.fsdp.size if model.fsdp else 1} data ranks, {sum(held)} held")
        return out

    loop.train = spy
    return launch_train.main(argv)


if __name__ == "__main__":
    raise SystemExit(launch(sys.argv[1:]))
