"""Serve a small LM with batched requests: prefill + decode loop, on PyTorch.

    python -m repro_torch.launch.serve_lm [--arch qwen3-1.7b] [--new 32] [--device cpu]

The port of ``examples/serve_lm.py``, every flag kept: the reduced config
of ``--arch``, seeded weights, ``--batch`` random prompts of
``--prompt-len`` tokens (seeded patches or frames for the VLM and whisper),
``--new`` tokens greedy (``--temperature 0``) or sampled. ``--device``
picks the device (the card unless ``--device cpu``). The weights are drawn
on the CPU and carried to the device (:func:`seeded_model`), so a command
serves the same model, and greedy decoding gives the same tokens, on every
device, as the reference's ``jax.random`` weights do.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import engine

    cfg = configs.reduced(configs.get_config(args.arch))
    model = seeded_model(cfg, args.device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
                              dtype=torch.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.n_patches, cfg.patch_dim)), dtype=torch.float32)
    if cfg.family == "audio":
        extra["frames"] = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.n_frames, cfg.d_model)), dtype=torch.float32)

    t0 = time.perf_counter()
    res = engine.generate(cfg, model, prompts, args.new, extra_inputs=extra or None,
                          temperature=args.temperature, seed=1)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new
    dev = model.embed.tok.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s; batch={args.batch}; device {name})")
    print("sample token ids:", res.tokens[0, :16].tolist())
    return 0


def seeded_model(cfg, device, seed: int = 0):
    """``cfg``'s seeded weights drawn on the CPU (a device's own generator
    draws other numbers for the same seed) and carried to ``device``."""
    from repro_torch.models import api

    return api.from_reference(cfg, api.to_reference(api.init_params(cfg, seed, device="cpu")),
                              device=device)


if __name__ == "__main__":
    raise SystemExit(main())

