"""The processes of ``test_torch_dist_process.py``: what each rank of a
4-process gloo group runs, importable without JAX (a spawned process
imports this module to find its function). No tests here.

Each rank syncs seeded per-rank gradient trees through a
``DistCommunicator`` by every method, over one axis and over ``("pod",
"data")``, hands a buffer along a partial perm, takes two butterfly train
steps of a reduced arch on its rows and three steps of the training loop,
and saves what it got with its byte counters. Then every rank meets at a
barrier, and the last rank raises while the others wait at a second one.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import collectives as coll
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist.process import DistCommunicator
from repro_torch.dist.sharding import SimMesh, rules_for_mesh
from repro_torch.models import api
from repro_torch.train import optim, step as step_mod
from repro_torch.train.loop import LoopConfig, train

WORLD = 4
# (method, fanout) over all ranks; "int8" is tree_sync_int8
METHODS = (("xla_psum", 2), ("butterfly", 1), ("butterfly", 2), ("butterfly", 4),
           ("rabenseifner", 2), ("rabenseifner", 4), ("all_to_all", 2), ("int8", 2))
POD_DATA = SimMesh((2, 2), ("pod", "data"))
HIERARCHICAL = (("butterfly", 2), ("rabenseifner", 2), ("int8", 2), ("xla_psum", 2),
                ("all_to_all", 2))
HANDOFF = [1, 2, 3, None]
LR_KW = {"peak": 1e-3, "warmup": 1, "total": 10}
STEPS = (1, 2)
BATCH, SEQ = 8, 16
FAILING_RANK = WORLD - 1


def grad_tree(world=WORLD):
    """Seeded float32 leaves ``[world, ...]``: row ``r`` is rank ``r``'s."""
    rng = np.random.default_rng(7)
    return {"a": torch.from_numpy(rng.normal(size=(world, 7, 5)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(size=(world, 13)).astype(np.float32))}}


def sync(tree, comm, method, fanout, axes=None):
    if method == "int8":
        return coll.tree_sync_int8(tree, comm, fanout=fanout, axes=axes)
    return coll.tree_sync(tree, comm, method=method, fanout=fanout, axes=axes)


def step_cfg():
    return configs.reduced(configs.get_config("olmo-1b"))


def rows(tree, r):
    return {k: rows(v, r) if isinstance(v, dict) else v[r:r + 1] for k, v in tree.items()}


def group_checks(rank, world, out_dir):
    torch.set_num_threads(1)
    res = {}
    tree = rows(grad_tree(world), rank)
    for method, fanout in METHODS:
        comm = DistCommunicator("cpu")
        res[f"sync/{method}/{fanout}"] = (sync(tree, comm, method, fanout),
                                          int(comm.bytes_sent[0]))
    for method, fanout in HIERARCHICAL:
        comm = DistCommunicator("cpu", POD_DATA)
        res[f"pod_data/{method}/{fanout}"] = (
            sync(tree, comm, method, fanout, ("pod", "data")), int(comm.bytes_sent[0]))
    comm = DistCommunicator("cpu")
    x = torch.full((1, 3), float(rank + 1))
    res["handoff"] = (comm.ppermute(x, HANDOFF), int(comm.bytes_sent[0]),
                      int(comm.sends[0]))
    res["pmean"] = float(comm.pmean(torch.tensor([float(rank)])))

    cfg = step_cfg()
    mesh = SimMesh(world)
    comm = DistCommunicator("cpu", mesh)
    fn = step_mod.build_train_step_butterfly(cfg, mesh, rules_for_mesh(mesh), method="butterfly",
                                             fanout=2, lr_kw=LR_KW, comm=comm)
    model = api.init_params(cfg, 0, device="cpu")
    state = optim.ADAMW.init(model)
    data = SyntheticLM(cfg, BATCH, SEQ)
    metrics = []
    for s in STEPS:
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
        model, state, m = fn(model, state, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    res["step"] = (api.to_reference(model), metrics)

    out = train(cfg, BATCH, SEQ, LoopConfig(n_steps=3, grad_sync="butterfly", log_every=100,
                                            lr_kw=LR_KW), ranks=world, device="cpu",
                comm=DistCommunicator("cpu"))
    res["loop"] = (api.to_reference(out["params"]), out["losses"])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    if rank == FAILING_RANK:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()  # never met: the failing rank has gone


def nudged_dist_child(rank, world, out_dir, job):
    """``chip_smoke.dist_child`` with rank 1's synced leaves moved by one ulp
    in their first element: its checksums then differ from the simulated
    rank's, so each leaf goes to rank 0 and is held within the relative
    tolerance there."""
    import chip_smoke

    real = chip_smoke.dist_sync_leaf

    def nudged(g, comm, method, fanout):
        out = real(g, comm, method, fanout)
        if rank == 1 and isinstance(comm, DistCommunicator):
            out = out.clone()
            first = out.view(-1)[:1]
            first.copy_(torch.nextafter(first, torch.full_like(first, float("inf"))))
        return out

    chip_smoke.dist_sync_leaf = nudged
    chip_smoke.dist_child(rank, world, out_dir, job)


def idle(rank, world):
    dist.barrier()


def hang(rank, world):
    import time

    time.sleep(600)
