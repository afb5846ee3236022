"""Deterministic, resumable synthetic LM data pipeline; the port's own
copy of ``repro.data.pipeline`` (numpy only), giving the same batches for
the same seed.

Fault-tolerance property: the batch for step ``i`` is a pure function of
(seed, step, shape) — there is no iterator state to checkpoint or lose, so a
restarted worker regenerates exactly the stream it would have seen.  This is
the "step-indexed PRNG" pattern; a real corpus plugs in behind the same
interface via ``MemmapCorpus`` (token file + step-indexed offsets).

Batches are produced host-side (numpy); the caller moves them to its
device.  ``host_slice`` gives one host its share of a global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 4096
    global_batch: int = 256


class SyntheticLM:
    """Markov-ish synthetic token stream: next token depends on the previous
    one so the LM loss is learnable (used by convergence tests)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # a sparse-ish transition preference table (paper flavour: skewed rows)
        self._shift = rng.integers(1, cfg.vocab_size, size=64)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b = rng.integers(0, cfg.vocab_size,
                         size=(cfg.global_batch, cfg.seq_len), dtype=np.int32)
        # inject learnable structure: token[t+1] = (token[t] + shift) % V often
        # (shift fixed across steps so the mapping is learnable)
        mask = rng.random((cfg.global_batch, cfg.seq_len - 1)) < 0.7
        nxt = (b[:, :-1] + self._shift[0]) % cfg.vocab_size
        b[:, 1:] = np.where(mask, nxt, b[:, 1:])
        tokens = b
        labels = np.concatenate([b[:, 1:], np.full((cfg.global_batch, 1), -1,
                                                   np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def host_slice(self, step: int, host_id: int, num_hosts: int) -> dict:
        full = self.batch(step)
        per = self.cfg.global_batch // num_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in full.items()}


class MemmapCorpus:
    """File-backed corpus with the same step-indexed contract."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        n = len(self.tokens) - cfg.seq_len - 1
        starts = rng.integers(0, n, size=cfg.global_batch)
        tok = np.stack([self.tokens[s : s + cfg.seq_len] for s in starts])
        lab = np.stack([self.tokens[s + 1 : s + cfg.seq_len + 1] for s in starts])
        return {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32)}
