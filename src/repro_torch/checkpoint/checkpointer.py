"""Atomic, async checkpointing with restore onto the target's devices.

Port of ``repro.checkpoint.checkpointer``, on the same on-disk format, so
a checkpoint written by either package restores in the other:
``step_XXXXXXXX/arrays.npz`` (arrays ``a0 .. a{n-1}``) and
``manifest.json`` (step, a description of the tree, ``n_arrays``,
``extra``, shapes, dtypes). Leaves are in JAX's flatten order: dict keys
sorted, tuples and named tuples (``AdamWState``: step, mu, nu;
``QTensor``: q, s) in field order. numpy has no bfloat16 of its own, so
a bfloat16 leaf is written as its 16-bit patterns (dtype ``bfloat16`` in
the manifest) and read back from them.

Contracts, as in the JAX package:

- **Atomicity**: writes go to ``step_XXXX.tmp/`` then ``os.rename`` to
  ``step_XXXX/``; ``latest()`` only ever sees committed directories.
- **Async**: the tensors are copied to host memory when ``save`` is
  called (so the caller may go on updating them), and written on a
  background thread; ``wait()`` joins it, before the next save, a
  restore, or at exit.
- **Restore** takes the *target* tree and puts each leaf on the device
  and in the dtype of the target's leaf.
- **Retention**: keeps the newest ``keep`` checkpoints, deletes older.
- **Preemption hook**: ``install_sigterm_handler`` saves on SIGTERM.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def flatten(tree) -> List[Any]:
    """Leaves in JAX's flatten order (see the module docstring)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in flatten(t)]
    return [tree]


def unflatten(like, leaves: List[Any]) -> Any:
    """``leaves`` into the structure of ``like`` (named tuples rebuilt)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the target tree holds")
    return out


def describe(tree) -> str:
    """The tree's structure as text (the manifest's ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "(" + ", ".join(describe(t) for t in tree) + ")"
    return "*"


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _from_host(a: np.ndarray, dtype_name: str, like) -> Any:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot ``tree`` (pytree of arrays) at ``step``."""
        self.wait()
        # snapshot to host memory synchronously, serialize async
        flat = flatten(tree)
        host = [_to_host(x) for x in flat]
        meta = {
            "step": int(step),
            "treedef": describe(tree),
            "n_arrays": len(host),
            "extra": extra or {},
            "shapes": [list(a.shape) for a in host],
            "dtypes": [_dtype_name(x) for x in flat],
        }

        def work():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"a{i}": a for i, a in enumerate(host)})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic commit
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from e

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any) -> Any:
        """Restore into the structure of ``target_tree``: each leaf on
        its target leaf's device, in its dtype. Returns (tree, extra)."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        npz = np.load(os.path.join(path, "arrays.npz"))
        host = [npz[f"a{i}"] for i in range(meta["n_arrays"])]
        flat_t = flatten(target_tree)
        if len(flat_t) != len(host):
            raise ValueError(
                f"checkpoint has {len(host)} arrays, target {len(flat_t)}")
        out = [_from_host(a, d, t)
               for a, d, t in zip(host, meta["dtypes"], flat_t)]
        return unflatten(target_tree, out), meta["extra"]

    # ------------------------------------------------------- preemption
    def install_sigterm_handler(self, save_fn: Callable[[], None]):
        """Run ``save_fn`` (then re-raise default behavior) on SIGTERM —
        the preemption notice of a cloud scheduler."""
        def handler(signum, frame):
            save_fn()
            self.wait()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        signal.signal(signal.SIGTERM, handler)
