"""Deterministic, restart-safe data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; the batches are byte-equal to the JAX
package's).

Two sources behind one interface:

* ``SyntheticSource`` — stateless PRNG stream: batch(step) is a pure function
  of (seed, step), so restart-at-step-N is exact with zero bookkeeping and
  every host materializes only its own shard.
* ``TextFileSource``  — byte-level tokens from a local corpus, packed into
  fixed-length sequences; position is derived from step (deterministic skip).

Batches are (tokens, targets) int32 and mask f32 arrays of shape (B, S);
the loader yields numpy so the caller controls device placement.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | textfile
    path: Optional[str] = None
    # host sharding: this host materializes rows [host_id::num_hosts]
    host_id: int = 0
    num_hosts: int = 1


class SyntheticSource:
    """Zipf-ish token stream with local n-gram structure (so loss can drop)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        b_loc = cfg.batch // cfg.num_hosts
        # zipf-distributed unigrams with a deterministic bigram successor rule
        z = rng.zipf(1.3, size=(b_loc, cfg.seq_len + 1)).astype(np.int64)
        base = (z - 1) % cfg.vocab_size
        succ = (base[:, :-1] * 31 + 7) % cfg.vocab_size
        mix = rng.random((b_loc, cfg.seq_len)) < 0.5
        stream = base.copy()
        stream[:, 1:][mix] = succ[mix]
        tokens = stream[:, :-1].astype(np.int32)
        targets = stream[:, 1:].astype(np.int32)
        mask = np.ones_like(tokens, np.float32)
        return {"tokens": tokens, "targets": targets, "mask": mask}


class TextFileSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        data = Path(cfg.path).read_bytes()
        self._tokens = np.frombuffer(data, dtype=np.uint8).astype(np.int32) % cfg.vocab_size
        assert len(self._tokens) > cfg.seq_len + 1, "corpus too small"

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b_loc = cfg.batch // cfg.num_hosts
        n = len(self._tokens) - cfg.seq_len - 1
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        starts = rng.integers(0, n, size=b_loc)
        rows = np.stack([self._tokens[s : s + cfg.seq_len + 1] for s in starts])
        return {
            "tokens": rows[:, :-1],
            "targets": rows[:, 1:],
            "mask": np.ones((b_loc, cfg.seq_len), np.float32),
        }


def make_source(cfg: DataConfig):
    return TextFileSource(cfg) if cfg.source == "textfile" else SyntheticSource(cfg)


def data_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Deterministic iterator; restart by passing the checkpointed step."""
    src = make_source(cfg)
    step = start_step
    while True:
        yield src.batch(step)
        step += 1
