"""Deterministic synthetic token stream (numpy only), with host prefetch.

batch(step) is a pure function of (seed, step): the same seed gives the
same prompts here as in the JAX package, so both sides serve identical
requests and train on identical batches, and restarting at step k replays
the identical stream. Tokens follow a Zipf-like distribution with induced
bigram structure. ``SyntheticPipeline`` prepares batches on a bounded
background thread while the device steps.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


def _tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish marginals + weak bigram coupling."""
    base = rng.zipf(1.3, size=shape).astype(np.int64)
    toks = (base - 1) % vocab
    # bigram structure: with p=0.3, t[i+1] = f(t[i])
    follow = (toks * 31 + 7) % vocab
    mask = rng.random(shape) < 0.3
    out = toks.copy()
    out[..., 1:] = np.where(mask[..., 1:], follow[..., :-1], toks[..., 1:])
    return out.astype(np.int32)


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """Returns batch(step) -> host-numpy batch dict. Pure in (seed, step)."""
    def fn(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        if cfg.family == "vlm":
            n_text = seq - cfg.num_patches
            toks = _tokens(rng, (batch, n_text + 1), cfg.vocab_size)
            return {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:].copy(),
                "patches": rng.standard_normal(
                    (batch, cfg.num_patches, cfg.patch_embed_dim),
                    dtype=np.float32),
            }
        if cfg.family == "encdec":
            toks = _tokens(rng, (batch, seq + 1), cfg.vocab_size)
            return {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:].copy(),
                "frames": rng.standard_normal(
                    (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32),
            }
        toks = _tokens(rng, (batch, seq + 1), cfg.vocab_size)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    return fn


class SyntheticPipeline:
    """Bounded-queue prefetching iterator over make_batch_fn."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        self.batch_fn = make_batch_fn(cfg, batch, seq, seed)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            b = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        step, b = self._q.get()
        self.step = step + 1
        return b

    def close(self):
        self._stop.set()
