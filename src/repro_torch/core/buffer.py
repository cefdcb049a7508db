"""Bounded on-device ring buffers + host ("DRAM") offload sink.

Port of ``repro.core.buffer``. The paper's counters buffer (start, end)
timestamps on chip and assert a dump signal to spill to DRAM when full.
Here the ring lives in the device state (``core.instrument``); the host
counts every probe's calls itself (it issues the transitions), so it
knows when a spill-enabled probe's ring fills and queues a copy of that
row to the host on the same stream (``non_blocking``, into pinned
memory), ordered after the event that filled it and before any later
one. ``HostSink`` keeps those rows and reassembles the full history.
Rows are int64 (depth, 2) (start, end) pairs.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch


def row_spans(row) -> List[Tuple[int, int]]:
    """A ring row ((depth, 2) int64) as (start, end) pairs."""
    return [tuple(r) for r in np.asarray(row, np.int64).reshape(-1, 2).tolist()]


class HostSink:
    """Host-side store for offloaded probe records.

    ``dump`` takes a ring row still on its way from the device (a pinned
    tensor filled by a queued copy, with the CUDA event recorded after
    it); ``records`` waits for the copies it reads. Subclasses override
    ``_store`` to consume rows differently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[int, List[Tuple[int, object]]] = defaultdict(list)
        self._pending: List[object] = []
        self.dumps = 0

    def dump(self, probe_id: int, base_count: int, ring_row: torch.Tensor,
             ready=None):
        """Offload one full ring row of ``probe_id`` (calls
        ``base_count`` .. ``base_count + depth - 1``). ``ready`` is the
        CUDA event after the copy, or None for a row already on the host."""
        with self._lock:
            self.dumps += 1
            if ready is not None:
                self._pending.append(ready)
        self._store(int(probe_id), int(base_count), ring_row)

    def _store(self, probe_id: int, base_count: int, row):
        with self._lock:
            self._rows[probe_id].append((base_count, row))

    def _wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for ev in pending:
            ev.synchronize()

    def records(self, probe_id: int) -> List[Tuple[int, int]]:
        """All offloaded (start, end) records of a probe, in call order."""
        self._wait()
        with self._lock:
            rows = sorted(self._rows.get(probe_id, []), key=lambda r: r[0])
        out: List[Tuple[int, int]] = []
        for _base, row in rows:
            out.extend(row_spans(row.numpy()))
        return out


def state_bytes(n_probes: int, depth: int) -> int:
    """On-device profiler state footprint (the resource-model 'FF' term):
    an int64 clock, and per probe three int64 counter planes
    (starts/totals/ends), an int64 call count and ``depth`` int64
    (start, end) ring slots."""
    per_probe = 3 * 8 + 8
    ring = depth * 2 * 8
    return 8 + n_probes * (per_probe + ring)
