"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, every flag kept: the fault-tolerant
loop on the card (``--device cpu`` for the CPU). ``--smoke`` swaps in the
reduced same-family config. The reference's host mesh, "whatever devices
exist", is here either

* the processes of a ``torch.distributed`` group, when the launcher runs
  under ``torchrun`` (``WORLD_SIZE`` set): one rank a process, the group
  the data axis, ``--backend`` gloo (CPU tensors, or CUDA tensors staged
  through pinned host memory) or nccl (one card a process), every
  ``--grad-sync`` through the butterfly step over the group (``xla`` as
  its ``xla_psum``), e.g. ``torchrun --nproc-per-node 4 -m
  repro_torch.launch.train --arch olmo-1b --smoke --grad-sync butterfly``;
* otherwise ``--ranks`` simulated ranks on one device, the axis a
  ``--grad-sync`` other than ``xla`` syncs over.

An FSDP config (``cfg.fsdp``: deepseek-7b, gemma3-27b, qwen3-moe,
kimi-k2, internvl2-26b, jamba-52b) with ``--grad-sync xla`` takes the
reference's FSDP rules on either mesh: the GSPMD step with every leaf's
``embed`` dimension split over the data axis (one block a process under
torchrun), its gathers and reduce-scatters over the group.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.dist.sharding import rules_for_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import LoopConfig, train

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-sync", default="xla",
                    choices=["xla", "butterfly", "rabenseifner", "all_to_all"])
    ap.add_argument("--fanout", type=int, default=2)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ranks", type=int, default=8,
                    help="simulated data-parallel ranks P (the leading tensor axis); "
                         "under torchrun the process group is the axis instead")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the torch.distributed backend under torchrun")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    loop = LoopConfig(
        n_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at,
        microbatches=args.microbatches, grad_sync=args.grad_sync,
        fanout=args.fanout,
        lr_kw={"warmup": 10, "total": args.steps},
    )
    if "WORLD_SIZE" not in os.environ:
        mesh = make_host_mesh(args.ranks)
        rules = rules_for_mesh(mesh, cfg.fsdp and args.grad_sync == "xla")
        out = train(cfg, args.batch, args.seq, loop, ranks=args.ranks, rules=rules,
                    device=args.device, mesh=mesh if rules.fsdp else None)
        rank = 0
    else:
        import torch
        import torch.distributed as dist

        from repro_torch.dist.process import DistCommunicator

        dist.init_process_group(args.backend, init_method="env://")
        try:
            device = torch.device(args.device)
            if device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("--device cuda: no CUDA device is available")
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                      % torch.cuda.device_count())
            comm = DistCommunicator(device, make_host_mesh(dist.get_world_size()))
            rules = rules_for_mesh(comm.mesh, cfg.fsdp and args.grad_sync == "xla")
            out = train(cfg, args.batch, args.seq, loop, ranks=comm.p, rules=rules,
                        device=device, comm=comm)
            rank = comm.rank
        finally:
            dist.destroy_process_group()
    losses = out["losses"]
    if rank == 0:
        print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
