"""Debug printing helpers (counterpart of ``peba1_tpu/utils/printing.py``):
the reference's printVector, printVect64 and printSlot64."""

from __future__ import annotations

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).reshape(-1)


def print_vector(v, size: int | None = None) -> str:
    """printVector: '[ v0 v1 ... ]', the first `size` values."""
    v = _host(v)
    if size is not None:
        v = v[:size]
    s = "[ " + " ".join(str(int(x)) for x in v) + " ]"
    print(s)
    return s


def print_vect64(v, length: int | None = None) -> str:
    """printVect64 (dead code in the reference, still exported)."""
    return print_vector(_host(v).astype(np.uint64), length)


def print_slot64(n: int) -> str:
    """printSlot64: '[unsigned signed bits-lsb-first]'."""
    u = int(np.uint64(n))
    s = int(np.int64(np.uint64(n)))
    bits = "".join(str((u >> i) & 1) for i in range(64))
    out = f"[{u} {s} {bits}]"
    print(out, end="")
    return out
