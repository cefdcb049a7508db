"""Parameters of the JAX package, carried into the port.

``params_from_numpy`` takes the nested dict that ``repro`` ``Model.init``
returns, converted leaf by leaf to numpy, and returns the port's
parameter tree on ``device``. Both packages share one layout, so the two
then compute the same function: this is how the tests hold the port
against the JAX package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``, dtypes kept (numpy's bfloat16 extension type included)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # an owned copy
