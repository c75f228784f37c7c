"""Deterministic, shardable token pipeline (port of
``repro/data/pipeline.py``: numpy only, so ``batch(step)`` gives the
reference's arrays bit for bit).

Synthetic LM data generator with the properties the trainer needs at
scale:

  * **deterministic & seekable**: batch ``i`` is a pure function of
    (seed, i) — restart/elastic-rescale replays exactly-once without
    storing stream state beyond the step counter,
  * **host-shardable**: each data-parallel host slices its rows of the
    global batch from the same logical stream (``host_slice``),
  * **structured**: token streams have Zipfian unigram structure plus
    copy/induction motifs so a ~100M model actually learns something
    measurable in a few hundred steps (examples/train driver),
  * **file-backed mode**: if a ``.npy`` corpus is supplied, batches are
    gathered from it with the same deterministic indexing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None
    zipf_alpha: float = 1.1
    motif_len: int = 16


class TokenPipeline:
    """Stateless-per-batch pipeline: ``batch(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._corpus = None
        if cfg.corpus_path:
            self._corpus = np.load(cfg.corpus_path, mmap_mode="r")
        # Zipf unigram distribution (stable across processes)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for ``step``: tokens + next-token labels."""
        cfg = self.cfg
        if self._corpus is not None:
            rng = np.random.default_rng((cfg.seed, step))
            starts = rng.integers(0, len(self._corpus) - cfg.seq_len - 1, cfg.global_batch)
            rows = np.stack(
                [self._corpus[s : s + cfg.seq_len + 1] for s in starts]
            ).astype(np.int32)
        else:
            rng = np.random.default_rng((cfg.seed, step))
            rows = rng.choice(
                cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1), p=self._probs
            ).astype(np.int32)
            # induction motifs: repeat a short random span later in the row
            m = cfg.motif_len
            if cfg.seq_len >= 4 * m:
                src = rng.integers(0, cfg.seq_len // 2 - m, cfg.global_batch)
                dst = rng.integers(cfg.seq_len // 2, cfg.seq_len - m, cfg.global_batch)
                for i in range(cfg.global_batch):
                    rows[i, dst[i] : dst[i] + m] = rows[i, src[i] : src[i] + m]
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def host_slice(self, step: int, host_id: int, n_hosts: int) -> Dict[str, np.ndarray]:
        """This host's rows of the global batch (contiguous row blocks)."""
        g = self.batch(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in g.items()}

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
