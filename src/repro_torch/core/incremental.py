"""Incremental re-instrumentation and evaluation caching (paper §IV-C.2).

Port of ``repro.core.incremental``. Vivado's incremental synthesis keeps
99 % of cells when RealProbe retargets; the eager analogue has three
layers:

1. the capture (hierarchy, segment table) is taken ONCE per function and
   argument shapes (``ProbedFunction.trace``) and reused verbatim by
   every retarget;
2. the *unprobed* function is never touched by probing: it runs as it
   did, and its outputs are bitwise the probed run's;
3. DSE measurements persist in an on-disk :class:`EvalCache` keyed by
   (kernel id, candidate config, capture fingerprint, device kind), so
   re-running the autotuner after an unrelated edit re-measures nothing,
   and an edit to a kernel changes the fingerprint of every candidate
   that reaches it and so invalidates exactly the stale entries.

The fingerprint (``capture_fingerprint``) stands in for JAX's hash of
the traced jaxpr: one run of the candidate under a recording dispatch
mode hashes its aten operation sequence with the shapes and dtypes of
every output, each hand-kernel call as one event with its grid plan's
signature, and the SHA-256 of the CUDA sources of each kernel it reaches
(``kernels._build.source_digest``).

``FileLock``, the JSON store and ``EvalCache`` are copies of the JAX
module's framework-free code; ``entry_key`` is byte-equal to JAX's for
the same key fields. ``measure_incremental`` quantifies the first two
layers: a cold capture, then a retarget, then the base call.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import scope

try:
    import fcntl
except ImportError:                       # non-POSIX: O_EXCL spin fallback
    fcntl = None

# the JAX package's probe-state layout version (``repro.core.instrument.
# STATE_LAYOUT_VERSION``, the packed layout): part of every entry key, so
# a key here is byte-equal to JAX's for the same fields
STATE_LAYOUT_VERSION = 2


class FileLock:
    """Advisory inter-process lock guarding read-merge-write saves.

    ``flock`` on a sidecar ``.lock`` file where available (released
    automatically by the OS if the holder dies), an ``O_EXCL``
    create-spin elsewhere. Sweep workers and concurrent tuner processes
    all mutate the same cache files; every mutation must happen under
    this lock or a whole-file rewrite from a stale snapshot silently
    drops the other writers' entries.
    """

    def __init__(self, path: str, *, timeout: float = 30.0,
                 poll: float = 0.005):
        self.path = path
        self.timeout = timeout
        self.poll = poll
        self._fd: Optional[int] = None
        self._excl = False

    def acquire(self) -> "FileLock":
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        deadline = time.monotonic() + self.timeout
        if fcntl is not None:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            while True:
                try:
                    fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    return self
                except OSError:
                    if time.monotonic() >= deadline:
                        os.close(self._fd)
                        self._fd = None
                        raise TimeoutError(
                            f"could not acquire lock {self.path} within "
                            f"{self.timeout:g}s")
                    time.sleep(self.poll)
        while True:
            try:
                self._fd = os.open(self.path,
                                   os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o644)
                self._excl = True
                return self
            except FileExistsError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"could not acquire lock {self.path} within "
                        f"{self.timeout:g}s")
                time.sleep(self.poll)

    def release(self) -> None:
        if self._fd is None:
            return
        try:
            if fcntl is not None and not self._excl:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
        finally:
            self._fd = None
            if self._excl:
                self._excl = False
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def _file_stamp(path: str) -> Optional[Tuple[int, int, int]]:
    """Freshness stamp of an on-disk JSON file (None when absent)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def _read_json(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_json(path: str, data: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


@dataclass
class IncrementalTimings:
    cold_total_s: float          # capture + probe selection + run
    retarget_total_s: float      # probe selection + run (capture reused)
    trace_s: float               # the capture run (trace and extraction)
    extract_s: float             # 0.0: one run both traces and extracts
    base_compile_reused: bool    # the unprobed function ran untouched
    reuse_fraction: float        # analogue of "99% of cells reused"

    def table(self) -> str:
        return (f"cold setup     : {self.cold_total_s * 1e3:9.1f} ms "
                f"(trace {self.trace_s * 1e3:.1f} ms, "
                f"extract {self.extract_s * 1e3:.1f} ms)\n"
                f"retarget       : {self.retarget_total_s * 1e3:9.1f} ms "
                f"({100 * self.retarget_total_s / max(self.cold_total_s, 1e-12):.1f}% of cold)\n"
                f"base executable: {'reused (untouched)' if self.base_compile_reused else 'RECOMPILED'}\n"
                f"artifact reuse : {self.reuse_fraction * 100:.1f}%")


# --------------------------------------------------- evaluation cache

DEFAULT_CACHE_DIR = os.path.join(".repro_cache", "dse")


class _Fingerprinter(TorchDispatchMode):
    """One run's aten operations (name, output shapes and dtypes) and
    kernel regions (name, plan signature, source digest), in order."""

    def __init__(self):
        super().__init__()
        self.items: List[Any] = []
        self.in_kernel = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.in_kernel:
            leaves = torch.utils._pytree.tree_leaves
            consts = tuple(repr(a) for a in leaves((args, kwargs))
                           if isinstance(a, (bool, int, float, str)))
            self.items.append((str(func), consts, tuple(
                (tuple(t.shape), str(t.dtype)) for t in leaves(out)
                if isinstance(t, torch.Tensor))))
        return out

    def kernel(self, name, cost, plan=None):
        return _FingerprintRegion(self, name, plan)


class _FingerprintRegion:
    probed = False

    def __init__(self, rec: _Fingerprinter, name: str, plan):
        self.rec, self.name, self.plan = rec, name, plan

    def __enter__(self):
        from repro_torch.kernels import _build
        sig = self.plan().signature() if self.plan is not None else None
        self.rec.items.append(("kernel", self.name, repr(sig),
                               _build.source_digest(self.name)))
        self.rec.in_kernel = True
        return self

    def fold(self, counters) -> None:
        """No counter block is asked for."""

    def __exit__(self, *exc):
        self.rec.in_kernel = False
        return False


def capture_ops(fn: Callable, args: Sequence[Any]) -> List[Any]:
    """One run of ``fn(*args)``'s operations, in order: each aten
    operation with its scalar arguments and its outputs' shapes and
    dtypes, each hand-kernel call as one item (name, grid plan
    signature, source digest). It runs ``fn`` once (on the card, its
    kernels launch)."""
    rec = _Fingerprinter()
    with scope.kernel_listener(rec), rec:
        fn(*args)
    return rec.items


def capture_fingerprint(fn: Callable, args: Sequence[Any]) -> str:
    """Content hash of one candidate as it runs (``capture_ops``): any
    edit to a kernel source, a wrapper's plan, the program, a constant
    it passes to an operation or the input shapes changes it; unrelated
    edits do not. The cache-key analogue of hashing the post-synthesis
    checkpoint."""
    return hashlib.sha256(
        repr(capture_ops(fn, args)).encode()).hexdigest()[:16]


def device_kind(device=None) -> str:
    """The device kind a measurement is keyed on: ``cuda:<name>`` of the
    given CUDA device (default: the current one, where a GPU exists), or
    ``cpu``."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return f"cuda:{torch.cuda.get_device_name(idx)}"
    return dev.type


class EvalCache:
    """On-disk memo of DSE measurements (the incremental-synthesis
    analogue: unchanged candidates are never re-measured).

    One JSON file maps entry keys (sha256 over kernel id, canonical
    config, fingerprint, device kind and the state layout) to the best
    measurement so far: ``{config, cycles_per_step, steps, ...}``, with
    each run's value and step-to-step spread by its steps (``history``,
    ``spreads``). A lookup hits only when
    the cached run covered at least as many steps as requested, so
    successive-halving finalists are always backed by long-enough runs;
    where a run of exactly the requested steps is cached, its value is
    returned (``at_steps``), so a warm successive halving ranks each rung
    by the values the cold one ranked it by (a noisy clock cannot send it
    down another path that needs a new measurement).

    Safe to share across processes: every mutation is a read-merge-write
    of the on-disk file under a :class:`FileLock`, a ``put`` never
    replaces an entry backed by a longer run, and reads reload whenever
    the file changed on disk.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        root = (cache_dir or os.environ.get("REPRO_DSE_CACHE")
                or DEFAULT_CACHE_DIR)
        self.root = os.path.expanduser(root)
        self.path = os.path.join(self.root, "evals.json")
        self.winners_path = os.path.join(self.root, "winners.json")
        self._data: Optional[Dict[str, Dict[str, Any]]] = None
        self._winners: Optional[Dict[str, Dict[str, Any]]] = None
        self._stamp: Optional[Tuple[int, int, int]] = None
        self._winners_stamp: Optional[Tuple[int, int, int]] = None

    # -- storage -------------------------------------------------------
    def _load(self) -> Dict[str, Dict[str, Any]]:
        stamp = _file_stamp(self.path)
        if self._data is None or stamp != self._stamp:
            self._data = _read_json(self.path)
            self._stamp = stamp
        return self._data

    def _mutate(self, path: str,
                mutator: Callable[[Dict[str, Any]], None]
                ) -> Tuple[Dict[str, Any], Optional[Tuple[int, int, int]]]:
        """Locked read-merge-write: re-read the CURRENT on-disk state,
        apply ``mutator`` to it, atomically write it back. Other
        processes' entries written since our last load survive."""
        os.makedirs(self.root, exist_ok=True)
        with FileLock(path + ".lock"):
            data = _read_json(path)
            mutator(data)
            _write_json(path, data)
            stamp = _file_stamp(path)
        return data, stamp

    @staticmethod
    def entry_key(kernel_id: str, config: Dict[str, Any],
                  fingerprint: str, device: str) -> str:
        blob = json.dumps([kernel_id, config, fingerprint, device,
                           STATE_LAYOUT_VERSION], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    # -- API -----------------------------------------------------------
    def get(self, kernel_id: str, config: Dict[str, Any], fingerprint: str,
            device: str, min_steps: int = 1) -> Optional[Dict[str, Any]]:
        e = self._load().get(self.entry_key(kernel_id, config, fingerprint,
                                            device))
        if e is None or e["steps"] < min_steps:
            return None
        e = dict(e, at_steps=e["steps"])
        exact = e.get("history", {}).get(str(min_steps))
        if exact is not None:
            e["cycles_per_step"], e["at_steps"] = exact, min_steps
            e["spread"] = e.get("spreads", {}).get(str(min_steps), 0.0)
        return e

    def put(self, kernel_id: str, config: Dict[str, Any], fingerprint: str,
            device: str, *, cycles_per_step: float, steps: int,
            spread: float = 0.0) -> Dict[str, Any]:
        """Record a measurement (its cycles a step and their step-to-step
        ``spread``); returns the entry now stored under the key. An entry
        is only replaced by a run of at least as many steps: a short
        re-measure can never downgrade a cached long-run finalist
        measurement."""
        key = self.entry_key(kernel_id, config, fingerprint, device)
        entry = {
            "kernel": kernel_id, "config": dict(config),
            "fingerprint": fingerprint, "device": device,
            "cycles_per_step": float(cycles_per_step), "steps": int(steps),
            "spread": float(spread),
        }

        def merge(data: Dict[str, Any]) -> None:
            cur = data.get(key)
            history = dict(cur.get("history", {})) if cur else {}
            spreads = dict(cur.get("spreads", {})) if cur else {}
            history[str(int(steps))] = float(cycles_per_step)
            spreads[str(int(steps))] = float(spread)
            if cur is not None and int(cur.get("steps", 0)) > int(steps):
                cur["history"], cur["spreads"] = history, spreads
                return
            data[key] = dict(entry, history=history, spreads=spreads)

        self._data, self._stamp = self._mutate(self.path, merge)
        return dict(self._data[key])

    def entries(self, kernel_id: Optional[str] = None,
                device: Optional[str] = None) -> list:
        out = []
        for e in self._load().values():
            if kernel_id is not None and e.get("kernel") != kernel_id:
                continue
            if device is not None and e.get("device") != device:
                continue
            out.append(dict(e))
        return out

    # -- winners (the DSE outcome record) -------------------------------
    def _load_winners(self) -> Dict[str, Dict[str, Any]]:
        stamp = _file_stamp(self.winners_path)
        if self._winners is None or stamp != self._winners_stamp:
            self._winners = _read_json(self.winners_path)
            self._winners_stamp = stamp
        return self._winners

    def set_winner(self, kernel_id: str, device: str,
                   config: Dict[str, Any], *, cycles_per_step: float,
                   shape: str = "") -> None:
        """Record the outcome of the LATEST tuning run for this kernel on
        this device at this input shape (``kernels.tuning.shape_key``;
        "" for none). Raw eval entries are not mutually comparable
        (cycles scale with the shape, and stale-fingerprint entries
        survive kernel edits), so the engine declares its winner
        explicitly and ``winners`` / ``best_config`` serve that. Unlike
        the JAX cache, winners of different shapes are kept apart: a
        tile is applied only at the shape it won at."""
        rec = {
            "kernel": kernel_id, "device": device, "config": dict(config),
            "cycles_per_step": float(cycles_per_step), "shape": shape,
        }

        def merge(w: Dict[str, Any]) -> None:
            rec["order"] = 1 + max((int(r.get("order", 0))
                                    for r in w.values()), default=0)
            w[f"{kernel_id}@{device}|{shape}"] = rec

        self._winners, self._winners_stamp = \
            self._mutate(self.winners_path, merge)

    def winners(self, kernel_id: str, device: Optional[str] = None
                ) -> Dict[str, Dict[str, Any]]:
        """This kernel's winners on this device: shape -> config."""
        dev = device if device is not None else device_kind()
        return {w["shape"]: dict(w["config"])
                for w in self._load_winners().values()
                if w["kernel"] == kernel_id and w["device"] == dev}

    def best_config(self, kernel_id: str, device: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
        """Config chosen by the most recent tuning run for this kernel on
        this device, at whatever shape (``winners`` keeps them by shape).
        For a hand-written cache with no winner record it falls back to
        the raw lowest-cycles eval entry."""
        dev = device if device is not None else device_kind()
        won = [w for w in self._load_winners().values()
               if w["kernel"] == kernel_id and w["device"] == dev]
        if won:
            latest = max(won, key=lambda w: int(w.get("order", 0)))
            return dict(latest["config"])
        es = self.entries(kernel_id, dev)
        if not es:
            return None
        best = min(es, key=lambda e: (e["cycles_per_step"], -e["steps"]))
        return dict(best["config"])

    def clear(self, kernel_id: Optional[str] = None) -> int:
        dropped = [0]

        def drop_entries(data: Dict[str, Any]) -> None:
            keys = [k for k, e in data.items()
                    if kernel_id is None or e.get("kernel") == kernel_id]
            dropped[0] = len(keys)
            for k in keys:
                del data[k]

        def drop_winners(w: Dict[str, Any]) -> None:
            for k in [k for k, e in w.items()
                      if kernel_id is None or e.get("kernel") == kernel_id]:
                del w[k]

        self._data, self._stamp = self._mutate(self.path, drop_entries)
        self._winners, self._winners_stamp = \
            self._mutate(self.winners_path, drop_winners)
        return dropped[0]

    def __len__(self) -> int:
        return len(self._load())


def tensors(x) -> List[torch.Tensor]:
    """The tensors among a pytree's leaves."""
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


def device_of(args) -> torch.device:
    """The device of the first tensor of ``args`` (the CPU if none)."""
    ts = tensors(args)
    return ts[0].device if ts else torch.device("cpu")


def sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_incremental(fn: Callable, args: Sequence[Any], cfg_a, cfg_b,
                        device=None) -> IncrementalTimings:
    """Cold probed call (capture + selection + run) under ``cfg_a``, then
    a retarget to ``cfg_b`` and a call (selection + run, the capture
    reused), then the unprobed function, whose output must be bitwise
    the probed runs' (the base path is untouched by probing)."""
    from repro_torch.core.pragma import probe
    dev = device_of(args)
    base = fn(*args)
    sync(dev)
    pf = probe(fn, cfg_a, device=device)
    t0 = time.perf_counter()
    out_a, _ = pf(*args)
    sync(dev)
    cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    pf.retarget(cfg_b)
    out_b, _ = pf(*args)
    sync(dev)
    retarget = time.perf_counter() - t0

    again = fn(*args)
    untouched = pf.captures == 1 and all(
        torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, w)
        for x, y, z, w in zip(tensors(base), tensors(out_a),
                              tensors(out_b), tensors(again)))
    trace = pf.capture_seconds
    return IncrementalTimings(
        cold_total_s=cold, retarget_total_s=retarget, trace_s=trace,
        extract_s=0.0, base_compile_reused=untouched,
        reuse_fraction=trace / max(trace + retarget, 1e-12))
