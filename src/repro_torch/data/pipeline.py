"""Deterministic, sharded, checkpointable token pipeline.

A copy of ``repro.data.pipeline`` (numpy only; the port keeps its own
copy and imports nothing of ``repro``): the same seed, step and host give
the same batches, bit for bit.

Production framing: every host materializes only its own shard of the
global batch (``host_batch = global_batch / num_hosts``), derived purely
from (seed, step, host_index) — so the pipeline is (a) exactly-once
resumable from just the step number stored in the checkpoint, and (b)
elastic: after restarting on a different host count the same global
stream is re-partitioned with no duplicated/skipped samples.

Two sources: ``synthetic`` (self-seeding LCG token stream; used by tests,
examples and benches) and ``memmap`` (fixed-shape binary token file).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None         # for memmap
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide num_hosts")
        return self.global_batch // self.num_hosts


@dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(step=int(d["step"]))


class TokenPipeline:
    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None):
        self.cfg = cfg
        self.state = state or PipelineState()
        self._mm = None
        if cfg.source == "memmap":
            if not cfg.path:
                raise ValueError("memmap source needs a path")
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    # -- deterministic sample addressing --------------------------------
    def _sample_tokens(self, global_sample_idx: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.seq_len + 1
        if self._mm is not None:
            total = (len(self._mm) - 1) // cfg.seq_len
            row = global_sample_idx % max(total, 1)
            start = row * cfg.seq_len
            return np.asarray(self._mm[start:start + n], dtype=np.int32)
        # synthetic: SplitMix64-hashed Markov stream — fully
        # index-addressable AND learnable (90% of transitions follow a
        # fixed affine next-token map, 10% are hash-random), so training
        # tests can assert the loss actually drops below ln(V).
        # (uint64 wraparound is intended — silence numpy warnings)
        idx = np.uint64((global_sample_idx * 1_000_003 +
                         cfg.seed * 7_777_777) % (1 << 64))
        out = np.empty(n, dtype=np.int32)
        x = idx
        old = np.seterr(over="ignore")
        V = cfg.vocab_size

        def nxt(x):
            x = (x + np.uint64(0x9E3779B97F4A7C15)) \
                & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = x
            z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
                & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
                & np.uint64(0xFFFFFFFFFFFFFFFF)
            return x, z ^ (z >> np.uint64(31))

        x, z = nxt(x)
        out[0] = int(z % np.uint64(V))
        for i in range(1, n):
            x, z = nxt(x)
            if int(z % np.uint64(10)):            # 90%: learnable map
                out[i] = (out[i - 1] * 5 + 17) % V
            else:                                 # 10%: hash-random
                out[i] = int((z >> np.uint64(8)) % np.uint64(V))
        np.seterr(**old)
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host-local batch for a given global step (pure function)."""
        cfg = self.cfg
        hb = cfg.host_batch
        base = step * cfg.global_batch + cfg.host_index * hb
        toks = np.stack([self._sample_tokens(base + i) for i in range(hb)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- elasticity -------------------------------------------------------
    def reshard(self, num_hosts: int, host_index: int) -> "TokenPipeline":
        """Same global stream, different host partitioning (restart after
        node loss / scale-up). Continues from the same global step."""
        cfg = dataclasses.replace(self.cfg, num_hosts=num_hosts,
                                  host_index=host_index)
        return TokenPipeline(cfg, PipelineState(step=self.state.step))
