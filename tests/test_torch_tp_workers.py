"""The processes of ``test_torch_tp_dist.py``: what each rank of a 4-process
gloo group on a (data 2, model 2) mesh runs, importable without JAX (a
spawned process imports this module to find its function). No tests here.

Each rank builds the reduced kimi-k2 (dense and MoE layers, a shared
expert, Adafactor) sharded over the model axis through a
``DistCommunicator``, serves its data group's rows (prefill, decode,
greedy ``generate``), takes GSPMD steps and butterfly steps on a copy, and
saves what it got with its model-axis record and byte counters. A second
group (``tp_family_checks``) takes reduced mamba2's gradient and GSPMD
step and reduced whisper's prefill.
"""

import dataclasses
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.process import DistCommunicator
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api
from repro_torch.serve import engine
from repro_torch.train import optim, step as step_mod

WORLD = 4
MESH = SimMesh((2, 2), ("data", "model"))
ARCH = "kimi-k2-1t-a32b"
BATCH, SEQ, NEW = 4, 16, 4
LR_KW = {"peak": 1e-3, "warmup": 1, "total": 10}
STEPS = (1, 2)


def cfg():
    return dataclasses.replace(configs.reduced(configs.get_config(ARCH)))


def batches():
    """The global batch of each step, from a seed."""
    c = cfg()
    rng = np.random.default_rng(5)
    out = []
    for _ in STEPS:
        toks = rng.integers(0, c.vocab, (BATCH, SEQ)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(np.roll(toks, -1, axis=1))})
    return out


def rows_of(t, group, groups):
    n = t.shape[0] // groups
    return t[group * n:(group + 1) * n]


def run(comm, mesh, group):
    """Everything one program does, on ``comm`` (simulated or one process
    of the group); ``group`` selects this program's data rows (None: the
    whole batch)."""
    c = cfg()
    rules = rules_for_mesh(mesh)
    groups = mesh.shape["data"]
    model = api.init_params(c, 0, device="cpu", rules=rules, mesh=mesh, comm=comm)
    tp = model.tp
    data = batches()
    prompts = data[0]["tokens"] if group is None else rows_of(data[0]["tokens"], group, groups)
    out = {}
    with torch.no_grad():
        logits, cache, pos = api.prefill_fn(c, rules, mesh)(model, {"tokens": prompts})
        out["prefill_logits"] = logits.clone()
        out["prefill_stats"] = {k: dict(v) for k, v in tp.stats.items()}
        tp.reset()
        cache = engine.prepare_decode_cache(c, cache, SEQ, SEQ + 1)
        dl, _ = api.decode_fn(c, rules, mesh)(model, cache, prompts[:, :1], SEQ)
        out["decode_logits"] = dl.clone()
        out["decode_stats"] = {k: dict(v) for k, v in tp.stats.items()}
    out["tokens"] = engine.generate(c, model, prompts, NEW, rules=rules, mesh=mesh).tokens
    for name, build in (("gspmd", lambda: step_mod.build_train_step(
                            c, mesh=mesh, rules=rules, lr_kw=LR_KW)),
                        ("butterfly", lambda: step_mod.build_train_step_butterfly(
                            c, mesh, rules, lr_kw=LR_KW,
                            comm=comm if group is not None else None))):
        m = api.init_params(c, 0, device="cpu", rules=rules, mesh=mesh, comm=comm)
        state = optim.get(c.optimizer).init(m)
        fn = build()
        m.tp.reset()
        losses, norms = [], []
        for s, b in zip(STEPS, data):
            m, state, metrics = fn(m, state, b, s)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": norms,
                     "params": api.to_reference(m),
                     "state": {"/".join(p): v.clone() for p, v in
                               _leaves(optim.global_state(m, state))},
                     "stats": {k: dict(v) for k, v in m.tp.stats.items()},
                     "bytes": int(m.tp.bytes_sent[0])}
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tp_group_checks(rank, world, out_dir):
    torch.set_num_threads(1)  # four processes on the host's cores
    comm = DistCommunicator("cpu", MESH)
    group = int(MESH.coords([rank])[0][0])
    torch.save(run(comm, MESH, group), os.path.join(out_dir, f"rank{rank}.pt"))


# -- the SSM and encoder-decoder families (``test_torch_tp_dist.py``'s
# second group): reduced mamba2's gradient and GSPMD step, reduced
# whisper's prefill

FAMILY_ARCHS = ("mamba2-130m", "whisper-medium")


def family_cfg(arch):
    return configs.reduced(configs.get_config(arch))


def family_batch(c):
    """The global batch of a family's config, from a seed."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, c.vocab, (BATCH, SEQ)).astype(np.int32)
    out = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    if c.family == "audio":
        out["frames"] = torch.from_numpy(
            rng.normal(size=(BATCH, c.n_frames, c.d_model)).astype(np.float32))
    return out


def run_families(comm, mesh, group):
    """mamba2's gradient (this group's rows, summed over the data axes as
    the GSPMD step sums it) and one GSPMD step; whisper's prefill of this
    group's rows; each with its model-axis record and bytes."""
    rules = rules_for_mesh(mesh)
    groups = mesh.shape["data"]

    def mine(b):
        return b if group is None else {k: rows_of(v, group, groups) for k, v in b.items()}

    out = {}
    c = family_cfg("mamba2-130m")
    data = family_batch(c)
    model = api.init_params(c, 0, device="cpu", rules=rules, mesh=mesh, comm=comm)
    loss, grads = step_mod._grads_of(api.train_loss_fn(c, rules, mesh), model, mine(data), 1)
    grads = api.global_leaves(model, shd.tree_map(model.tp.data_sum, grads))
    out["grad_loss"] = float(loss)
    out["grads"] = {"/".join(p): g.clone() for p, g in _leaves(grads)}
    out["grad_stats"] = {k: dict(v) for k, v in model.tp.stats.items()}
    model.tp.reset()
    state = optim.get(c.optimizer).init(model)
    fn = step_mod.build_train_step(c, mesh=mesh, rules=rules, lr_kw=LR_KW)
    model, state, metrics = fn(model, state, data, STEPS[0])
    out["step"] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "params": api.to_reference(model),
                   "stats": {k: dict(v) for k, v in model.tp.stats.items()},
                   "bytes": int(model.tp.bytes_sent[0])}
    c = family_cfg("whisper-medium")
    data = mine(family_batch(c))
    model = api.init_params(c, 0, device="cpu", rules=rules, mesh=mesh, comm=comm)
    with torch.no_grad():
        logits, cache, _ = api.prefill_fn(c, rules, mesh)(
            model, {"tokens": data["tokens"], "frames": data["frames"]})
    out["prefill_logits"] = logits.clone()
    out["prefill_cache"] = {"/".join(p): t.clone() for p, t in _leaves(cache)}
    out["prefill_stats"] = {k: dict(v) for k, v in model.tp.stats.items()}
    out["prefill_bytes"] = int(model.tp.bytes_sent[0])
    return out


def tp_family_checks(rank, world, out_dir):
    torch.set_num_threads(1)
    comm = DistCommunicator("cpu", MESH)
    group = int(MESH.coords([rank])[0][0])
    torch.save(run_families(comm, MESH, group), os.path.join(out_dir, f"rank{rank}.pt"))
