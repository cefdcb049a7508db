"""Bounded on-device ring buffers + host ("DRAM") offload sink.

Port of ``repro.core.buffer``. The paper's counters buffer (start, end)
timestamps on chip and assert a dump signal to spill to DRAM when full.
Here the ring lives in the device state (``core.instrument``); the host
counts every probe's calls itself (it issues the transitions), so it
knows when a spill-enabled probe's ring fills and queues a copy of that
row to the host on the same stream (``non_blocking``), ordered after the
event that filled it and before any later one. A run copies its rows
into one pinned block and hands them to the sink once, at its end, with
ONE CUDA event recorded after the last copy (a pinned allocation and an
event per row cost far more host time than the copy). ``HostSink``
keeps those rows and reassembles the full history. Rows are int64
(depth, 2) (start, end) pairs.
"""
from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch


def row_bounds(row) -> Tuple[np.ndarray, np.ndarray]:
    """A ring row ((depth, 2) int64, numpy or a CPU tensor) as (starts,
    ends) int64 arrays, the whole-array form the vectorized consumers
    use."""
    r = np.asarray(row, np.int64).reshape(-1, 2)
    return r[:, 0].copy(), r[:, 1].copy()


def row_spans(row) -> List[Tuple[int, int]]:
    """A ring row ((depth, 2) int64) as (start, end) pairs."""
    starts, ends = row_bounds(row)
    return list(zip(starts.tolist(), ends.tolist()))


def row_durations(row) -> np.ndarray:
    """A ring row as per-call cycle durations (int64)."""
    starts, ends = row_bounds(row)
    return ends - starts


def rows_array(rows: Sequence) -> np.ndarray:
    """Blocks of ring rows ((k, depth, 2) each, numpy or CPU tensors), in
    order, as one (K, depth, 2) int64 array."""
    arrs = [np.asarray(r, np.int64) for r in rows]
    depth = arrs[0].shape[-2]
    return np.concatenate([a.reshape(-1, depth, 2) for a in arrs])


class HostSink:
    """Host-side store for offloaded probe records.

    ``dump`` takes one run's full ring rows, possibly still on their way
    from the device (views of a pinned block filled by queued copies,
    with the CUDA event recorded after the last one); ``records`` waits
    for the copies it reads. Subclasses override ``_store``, which gets
    the rows with their event, to consume rows differently
    (``streaming.StreamingSink`` folds them into constant-size aggregates
    on a worker thread, which waits on the event)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._batches: List[Tuple[List[int], List[int], Sequence]] = []
        self._pending: List[object] = []
        self.dumps = 0
        self.bytes_received = 0        # the offloaded rows' bytes

    def reset(self):
        """Forget every offloaded row (a DSE point starts from an empty
        sink)."""
        self._wait()
        with self._lock:
            self._batches.clear()
            self.dumps = 0
            self.bytes_received = 0

    def dump(self, probe_ids: Sequence[int], base_counts: Sequence[int],
             rows: Sequence, ready=None):
        """Offload full ring rows: row i (of the blocks ``rows``, in
        order) is probe ``probe_ids[i]``'s calls ``base_counts[i]`` ..
        ``base_counts[i] + depth - 1``. ``ready`` is the CUDA event after
        the copies, or None for rows already on the host."""
        nbytes = sum(int(r.numel()) * r.element_size() if
                     isinstance(r, torch.Tensor) else int(np.asarray(r).nbytes)
                     for r in rows)
        with self._lock:
            self.dumps += len(probe_ids)
            self.bytes_received += nbytes
        self._store(list(probe_ids), list(base_counts), rows, ready)

    def _store(self, probe_ids: List[int], base_counts: List[int], rows,
               ready=None):
        with self._lock:
            self._batches.append((probe_ids, base_counts, rows))
            if ready is not None:
                self._pending.append(ready)

    def _wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for ev in pending:
            ev.synchronize()

    def records(self, probe_id: int) -> List[Tuple[int, int]]:
        """All offloaded (start, end) records of a probe, in call order."""
        self._wait()
        with self._lock:
            batches = list(self._batches)
        found = []
        for pids, bases, rows in batches:
            arr = rows_array(rows)
            found += [(b, arr[i]) for i, (p, b) in enumerate(zip(pids, bases))
                      if p == probe_id]
        out: List[Tuple[int, int]] = []
        for _base, row in sorted(found, key=lambda r: r[0]):
            out.extend(row_spans(row))
        return out


def state_bytes(n_probes: int, depth: int) -> int:
    """On-device profiler state footprint (the resource-model 'FF' term):
    an int64 clock, and per probe three int64 counter planes
    (starts/totals/ends), an int64 call count and ``depth`` int64
    (start, end) ring slots."""
    per_probe = 3 * 8 + 8
    ring = depth * 2 * 8
    return 8 + n_probes * (per_probe + ring)
