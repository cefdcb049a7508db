"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/<name>-<digest>.so`` at the repository root (a
directory ``.gitignore`` lists), where ``<digest>`` hashes the source, the
headers it includes from ``csrc/`` (``<kernel>.cuh``, shared by the
translation units of one kernel's tiles) and the flags, so an edited
source is rebuilt and an unchanged one is not.
Nothing is built when a module is imported: ``load`` builds at the first
launch, and ``build`` compiles every source at once, one ``nvcc`` process
per file, all started together.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code, so a launch
the card refuses (too much shared memory, a bad grid) is never silent.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# opt-in shared memory per block on sm_90 (H100/H200): 227 KB
SMEM_OPTIN_BYTES = 232448

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _text(name: str) -> bytes:
    """A translation unit's source followed by the ``csrc/`` headers it
    includes, in the order it includes them."""
    src = (CSRC / f"{name}.cu").read_bytes()
    heads = re.findall(rb'#include "([^"]+)"', src)
    return src + b"".join((CSRC / h.decode()).read_bytes() for h in heads)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        _text(name) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def source_digest(kernel: str) -> str:
    """SHA-256 of every ``csrc/`` file of one kernel: its translation
    units and header (``<kernel>.cu``, ``<kernel>_*.cu``, ``<kernel>.cuh``).
    The DSE cache keys of a candidate that reaches the kernel include it,
    so an edit of the kernel invalidates that kernel's entries only."""
    files = sorted(p for p in CSRC.iterdir()
                   if p.suffix in (".cu", ".cuh")
                   and (p.stem == kernel or p.stem.startswith(kernel + "_")))
    if not files:
        raise KeyError(f"no CUDA source for kernel {kernel!r} in {CSRC}")
    h = hashlib.sha256()
    for p in files:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) from the build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc per source in parallel; returns name -> library path."""
    names = list(names) if names is not None else sources()
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{build_log(n)}" for n in failed))
    return {name: library_path(name) for name in names}


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use),
    with ``argtypes`` set from ``signatures`` and an ``int`` result for
    every entry. Pointers and the stream must be ``c_void_p`` there, or
    ctypes passes them as 32-bit ints."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            entry = getattr(lib, fn)
            entry.argtypes = argtypes
            entry.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.error_string(code).decode()})")
