"""Deterministic synthetic data pipeline (the port of ``repro.data.pipeline``,
a numpy copy: the reference module imports no JAX, and the port imports
nothing of the reference).

* **sharded**: each data-parallel slice draws its own batch shard from a
  per-(step, shard) seeded generator, with no coordination;
* **restart-deterministic**: ``batch_at(step)`` is a pure function of
  (seed, step), so checkpoint/restart resumes the exact stream with no
  state to save;
* **self-supervised structure**: token streams are Zipf-distributed with a
  short induction pattern, so a real LM loss signal exists.

Whisper gets frame embeddings and the VLM patch embeddings, both drawn
here. ``batch_at`` returns numpy arrays equal bit for bit to the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2
    pattern_len: int = 8  # induction: second half of each pattern repeats


class SyntheticLM:
    """batch_at(step) -> {tokens, labels[, frames | patches]}."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 dcfg: DataConfig = DataConfig()):
        self.cfg, self.batch, self.seq, self.dcfg = cfg, batch, seq, dcfg

    def _tokens(self, rng: np.random.Generator, n: int, l: int) -> np.ndarray:
        v = self.cfg.vocab
        z = rng.zipf(self.dcfg.zipf_a, size=(n, l)) % (v - 1) + 1
        pl = self.dcfg.pattern_len
        t = z.astype(np.int32)
        # copy each pattern's first half into its second half (induction)
        full = (l // pl) * pl
        view = t[:, :full].reshape(n, -1, pl)
        view[:, :, pl // 2:] = view[:, :, :pl // 2]
        return t

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        if self.batch % n_shards:
            raise ValueError(f"batch {self.batch} does not split into {n_shards} shards")
        n = self.batch // n_shards
        rng = np.random.default_rng([self.dcfg.seed, step, shard])
        cfg = self.cfg
        l = self.seq
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            lt = l - cfg.n_patches
            out["patches"] = rng.normal(size=(n, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
            t = self._tokens(rng, n, lt + 1)
        elif cfg.family == "audio":
            out["frames"] = rng.normal(size=(n, cfg.n_frames, cfg.d_model)).astype(np.float32)
            t = self._tokens(rng, n, l + 1)
        else:
            t = self._tokens(rng, n, l + 1)
        out["tokens"] = t[:, :-1]
        out["labels"] = t[:, 1:].copy()
        return out
