"""Mesh construction and the per-device processes behind it.

Port of ``repro.launch.mesh``. A JAX mesh is N devices of one process;
here it is N processes, one a device, over ``torch.distributed`` (NCCL
on the card, gloo on the CPU), and the mesh is a ``DeviceMesh`` whose
``mesh_dim_names`` are the JAX axis names. ``spawn`` starts the ranks,
``make_mesh`` builds the mesh inside each.

Axis sizes are validated eagerly, as in the JAX package: a shape whose
product is not the world size raises with the factorizations that
would fit. ``parse_mesh_arg`` and ``probe_axis_names`` are the JAX
package's.

``make_production_mesh`` (16x16 = 256 devices, two pods 512) builds the
production mesh for a dry run (``launch.dryrun``) that needs no card:
rank 0 of a world of that size over PyTorch's ``fake`` process-group
backend, whose collectives return at once and move nothing. It is a
context manager, because the default process group it creates is
destroyed on exit, so nothing leaks into the caller's process.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def _factorizations(n: int, k: int) -> Tuple[Tuple[int, ...], ...]:
    """All ordered k-tuples of positive ints whose product is n."""
    if k == 1:
        return ((n,),)
    out = []
    for d in range(1, n + 1):
        if n % d == 0:
            out.extend((d,) + rest for rest in _factorizations(n // d, k - 1))
    return tuple(out)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def validate_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                        world: Optional[int] = None) -> None:
    """Raise unless ``prod(shape)`` is the world size (the ranks of this
    process group; 1 without one)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but "
                         f"{len(axes)} axis names {tuple(axes)}")
    n = 1
    for s in shape:
        if s < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        n *= s
    dc = _world_size() if world is None else int(world)
    if n != dc:
        opts = _factorizations(dc, len(shape))
        raise ValueError(
            f"mesh shape {shape} needs {n} devices but the world size is "
            f"{dc}; pick a {len(shape)}-axis factorization of {dc}: "
            f"{list(opts[:16])}"
            + (" …" if len(opts) > 16 else ""))


def make_mesh(shape, axes, device_type: Optional[str] = None):
    """A validated ``DeviceMesh`` over this process group's ranks, rank r
    at mesh coordinate ``unravel_index(r, shape)``. ``device_type``
    defaults to the backend's: cuda for NCCL, cpu for gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    validate_mesh_shape(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run inside "
                           "launch.mesh.spawn")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group for the body: ``world_size`` ranks over
    PyTorch's ``fake`` backend, this process ``rank``; destroyed on exit.
    Raises if a process group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import compat
    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process with no process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()
        compat.forget_dtensor_plans()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False):
    """``with make_production_mesh() as mesh``: the (16, 16) ("data",
    "model") mesh of 256 devices, or with ``multi_pod`` the (2, 16, 16)
    ("pod", "data", "model") mesh of 512, over a ``fake_world`` seen from
    rank 0 (a ``DeviceMesh`` of device type cpu: its tensors may be
    ``meta``). The world ends with the body."""
    from repro_torch.distributed import compat
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for a in shape:
        n *= a
    with fake_world(n):
        mesh = make_mesh(shape, axes, device_type="cpu")
        try:
            yield mesh
        finally:
            compat.forget_mesh(mesh)


def probe_axis_names(shape) -> Tuple[str, ...]:
    """Axis names for a probing mesh: ('dev',) or ('dev0', 'dev1', …)."""
    return ("dev",) if len(shape) == 1 else \
        tuple(f"dev{i}" for i in range(len(shape)))


def parse_mesh_arg(arg) -> Tuple[int, ...]:
    """CLI mesh shape: '8' -> (8,), '2x4' or '2,4' -> (2, 4); None/''
    -> () (no mesh)."""
    if not arg:
        return ()
    parts = [p for p in str(arg).replace("x", ",").split(",") if p.strip()]
    try:
        return tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"bad --mesh {arg!r}: expected e.g. '8' or '2x4'")


# -------------------------------------------------------------- ranks

def _rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _entry(rank: int, fn: Callable, n: int, backend: str, device: str,
           store_path: str, timeout: float, args: tuple, kwargs: dict,
           out_dir: str):
    import faulthandler
    import torch.distributed as dist
    # a native crash (no Python exception) leaves its Python stack here
    fault = open(os.path.join(out_dir, f"rank{rank}.fault"), "w")
    faulthandler.enable(file=fault)
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout),
        **({"device_id": dev} if backend == "nccl" else {}))
    try:
        result = fn(rank, dev, *args, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
        faulthandler.disable()
        fault.close()


def spawn(fn: Callable, mesh_shape: Sequence[int], *,
          backend: Optional[str] = None, device: str = "cpu",
          args: tuple = (), kwargs: Optional[dict] = None,
          timeout: float = 120.0) -> List[Any]:
    """Run ``fn(rank, device, *args, **kwargs)`` on ``prod(mesh_shape)``
    ranks, one process each (the ``spawn`` start method), over a
    ``FileStore`` in a
    fresh temporary directory (no TCP port, so concurrent test workers
    never collide). Returns each rank's result, by rank (it must pickle).

    ``backend`` defaults to NCCL for ``device="cuda"`` and gloo for the
    CPU. NCCL takes one card a rank: with more ranks than visible cards
    it raises (pass ``backend="gloo"`` to put several ranks on a card).
    ``timeout`` bounds every collective, so a hung rank fails in seconds.
    If any rank raises or exits nonzero, this raises with that rank's
    traceback (for a native crash, its Python stack by ``faulthandler``). ``fn`` must be importable by name (a module's top-level
    function), since each rank imports it afresh."""
    import torch.multiprocessing as mp
    n = 1
    for s in mesh_shape:
        n *= int(s)
    dtype = torch.device(device).type
    if backend is None:
        backend = "nccl" if dtype == "cuda" else "gloo"
    if backend == "nccl":
        if dtype != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'")
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(
                f"NCCL takes one card a rank: {n} ranks, {cards} visible "
                f"card(s); pass backend=\"gloo\" to share cards")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        try:
            mp.spawn(_entry, args=(fn, n, backend, device,
                                   os.path.join(tmp, "store"), float(timeout),
                                   tuple(args), dict(kwargs or {}), tmp),
                     nprocs=n, join=True)
        except Exception as e:
            detail = ""
            for f in sorted(os.listdir(tmp)):
                if f.endswith((".err", ".fault")):
                    with open(os.path.join(tmp, f)) as fh:
                        text = fh.read()
                    if text:
                        detail += f"\n--- {f.rsplit('.', 1)[0]} ---\n{text}"
            raise RuntimeError(f"a rank of {fn.__name__} failed: {e}"
                               f"{detail}") from None
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
