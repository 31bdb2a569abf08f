"""Deterministic synthetic data pipeline with host-side prefetch.

The port of the reference's ``repro/data/synthetic.py``: a reproducible token
stream (hash-mixed counter -> vocab ids), bit for bit the reference's numpy
stream, so training curves are comparable across runs, restarts and the two
packages. ``PrefetchLoader`` builds batches on a background thread into
pinned host memory and copies them to the card asynchronously
(``non_blocking=True``), keeping the copy off the critical path (the
paper's §5.2 lesson). For whisper a batch also holds ``frames``, and for
the stub vision and audio frontends ``embeds`` in place of tokens (qwen2-vl
with M-RoPE ``positions``), drawn in fp32 by the reference's numpy
generator and rounded to bf16, so they equal the reference's bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models.context import resolve_device


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 16)) * np.uint64(0x45d9f3b)
    x = (x ^ (x >> 16)) * np.uint64(0x45d9f3b)
    return x ^ (x >> 16)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    seed: int = 0) -> dict:
    """Deterministic batch for (cfg, shape, step) of CPU tensors: int32
    ``tokens`` and ``labels`` (B, S); whisper adds bf16 ``frames`` (B, S,
    d); a vision or audio frontend takes bf16 ``embeds`` (B, S, d) in
    place of tokens, vision int32 ``positions`` (3, B, S) too. Structured
    so next-token prediction is learnable (tokens follow a
    mixed-congruential pattern)."""
    B, S = shape.global_batch, shape.seq_len
    base = np.arange(B * (S + 1), dtype=np.uint64).reshape(B, S + 1)
    base += np.uint64(step * 1000003 + seed * 7919)
    # markov-ish stream: next token depends on position bucket
    stream = (_mix(base // np.uint64(4)) % np.uint64(cfg.vocab_size)
              ).astype(np.int32)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def drawn():
        # fp32 draws rounded to nearest even, as the reference's
        # jnp.asarray(a, jnp.bfloat16) rounds them
        rng = np.random.default_rng(step + seed)
        return torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), np.float32)).to(torch.bfloat16)
    labels = ints(stream[:, 1:S + 1])
    if cfg.encoder_decoder:
        return {"frames": drawn(), "tokens": ints(stream[:, :S]),
                "labels": labels}
    if cfg.frontend == "vision":
        return {"embeds": drawn(), "positions": ints(np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S))),
            "labels": labels}
    if cfg.frontend == "audio":
        return {"embeds": drawn(), "labels": labels}
    return {"tokens": ints(stream[:, :S]), "labels": labels}


class PrefetchLoader:
    """Background-thread batch producer with a bounded queue.

    The thread builds each batch and, for a CUDA ``device``, pins it; the
    consumer's ``next`` copies it to ``device`` with ``non_blocking=True``
    on the current stream. Yields (step, batch).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 start_step: int = 0, seed: int = 0, depth: int = 2,
                 device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        pin = self.device.type == "cuda"
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, self.shape, step, self.seed)
            if pin:
                batch = {k: v.pin_memory() for k, v in batch.items()}
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, {k: v.to(self.device, non_blocking=True)
                      for k, v in batch.items()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
