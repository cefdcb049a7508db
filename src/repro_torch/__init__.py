"""PyTorch + CUDA port of the ``repro`` package, for NVIDIA Hopper.

The module tree mirrors ``src/repro/`` (configs, models, kernels, engine,
launch), so each module names the JAX module it is held against. This
package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``. Its CUDA kernels are built from ``csrc/`` at first use (see
``kernels/_build.py``); importing any module builds nothing.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU they raise rather than quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU, which
    must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
