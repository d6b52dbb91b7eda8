"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``, every flag kept: the fault-tolerant
loop on the card (``--device cpu`` for the CPU). ``--smoke`` swaps in the
reduced same-family config. The reference's host mesh is ``--ranks``
simulated ranks on one device, the axis a ``--grad-sync`` other than
``xla`` syncs over.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.dist.sharding import SimMesh, rules_for_mesh
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
                    help="simulated data-parallel ranks P (the leading tensor axis)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    mesh = SimMesh(args.ranks)
    rules = rules_for_mesh(mesh, cfg.fsdp and args.grad_sync == "xla")
    out = train(
        cfg, args.batch, args.seq,
        LoopConfig(
            n_steps=args.steps, ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at,
            microbatches=args.microbatches, grad_sync=args.grad_sync,
            fanout=args.fanout,
            lr_kw={"warmup": 10, "total": args.steps},
        ),
        ranks=args.ranks, rules=rules, device=args.device,
    )
    losses = out["losses"]
    print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
