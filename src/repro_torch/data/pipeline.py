"""Deterministic synthetic data pipeline for LM training (counterpart of
``repro.data.pipeline``; the numpy generator is the reference's, so batch
``i`` is bit for bit the reference's).

  * deterministic and seekable: batch ``i`` is a pure function of (seed,
    i), so a restart from a checkpoint at step N reproduces the stream
    without replaying N batches;
  * sharded: each data-parallel host materialises only its slice
    (``host_slice``);
  * next-token labels, and the modality stubs (embeds, M-RoPE positions,
    source frames) the arch config asks for.

The generator is a structured Markov-ish token stream (not iid uniform), so
the loss is learnable.  Tokens, labels and positions are int32 tensors,
the stubs float32, all on the pipeline's device (the card unless
``device`` names another).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.coo import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    device: DeviceLike = None

    def batch_at(self, index: int, *,
                 host_slice: slice | None = None) -> dict:
        """The full (or host-local) batch for step ``index``."""
        rng = np.random.default_rng((self.seed, index))
        b = self.batch
        # Markov stream: next token = (a * tok + noise) % vocab
        v = self.cfg.vocab
        toks = np.empty((b, self.seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        mult = rng.integers(1, 17, size=(b, 1))
        for t in range(1, self.seq + 1):
            noise = rng.integers(0, 7, size=b)
            toks[:, t] = (toks[:, t - 1] * mult[:, 0] + noise) % v
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.input_mode == "embeds":
            batch["embeds"] = rng.standard_normal(
                (b, self.seq, self.cfg.d_model), dtype=np.float32)
            del batch["tokens"]
        if self.cfg.rope == "mrope":
            batch["positions"] = np.broadcast_to(
                np.arange(self.seq, dtype=np.int32), (3, b, self.seq)).copy()
        if self.cfg.encdec:
            batch["src_embeds"] = rng.standard_normal(
                (b, min(self.seq, 512), self.cfg.d_model), dtype=np.float32)
        if host_slice is not None:
            batch = {k: a[host_slice] if k != "positions"
                     else a[:, host_slice] for k, a in batch.items()}
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for k, a in batch.items()}


def make_batch_iterator(cfg: ModelConfig, batch: int, seq: int, *,
                        seed: int = 0, start_step: int = 0,
                        device: DeviceLike = None) -> Iterator[dict]:
    pipe = TokenPipeline(cfg, batch, seq, seed, device)
    i = start_step
    while True:
        yield pipe.batch_at(i)
        i += 1
