"""The device a tool runs on, what its records say of it, and the host
constants the program keeps on it.

A tool runs on the card unless the caller asks for the CPU; a request for
the card on a machine without one fails, it never falls back.
"""

from __future__ import annotations

import subprocess
from collections import OrderedDict

import numpy as np
import torch

from .logging import span


def require(name: str) -> torch.device:
    """torch.device(name), with the current card's index for "cuda";
    SystemExit (non-zero) for "cuda" without a card."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain path)")
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


# Host constants kept on their device by value (`from_host`), least
# recently used out.  A constant every bootstrap call uses is used again
# long before KEPT_ENTRIES other values pass, so values seen once (a
# request's nonce words) only evict each other.  Larger values are uploaded
# but not kept.
KEPT_ENTRIES = 256
KEPT_BYTES_MAX = 1 << 16
_kept: OrderedDict = OrderedDict()      # key -> (tensor, its _version)

uploads = {"hits": 0, "misses": 0}


def reset_uploads() -> None:
    for name in uploads:
        uploads[name] = 0


def forget_constants() -> None:
    """Empty the cache of `from_host`: its next values are uploaded anew."""
    _kept.clear()


def from_host(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values (a Python number, a list or tuple of them, a numpy array)
    as a tensor of `dtype` on `device`, kept there by value.

    Equal values (as numpy arrays: shape, dtype and bytes) with the same
    dtype and device give the same tensor, so a caller never writes the
    result in place; a hit on a tensor written since raises RuntimeError.
    A hit is a dictionary lookup.  A miss uploads inside the span
    ``peba1.sync_copy``: to a card through pinned memory, ordered on the
    device's current stream, without waiting for it.  `uploads` counts hits
    and misses.  A tensor is only moved to `device` and `dtype`.
    """
    if isinstance(values, torch.Tensor):
        return values.to(device, dtype)
    device = _resolve(device)
    a = np.asarray(values)
    key = None if a.dtype.hasobject or a.nbytes > KEPT_BYTES_MAX else (
        a.shape, a.dtype.str, a.tobytes(), dtype, device)
    if key in _kept:
        kept, version = _kept[key]
        if kept._version != version:
            raise RuntimeError("a constant kept by from_host was written in place")
        _kept.move_to_end(key)
        uploads["hits"] += 1
        return kept
    uploads["misses"] += 1
    with span("sync_copy"):
        if device.type == "cuda":
            out = torch.tensor(values, dtype=dtype).pin_memory().to(device, non_blocking=True)
        else:
            out = torch.tensor(values, dtype=dtype, device=device)
    if key is not None:
        _kept[key] = (out, out._version)
        if len(_kept) > KEPT_ENTRIES:
            _kept.popitem(last=False)
    return out


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def name(device) -> str:
    """The card's name, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit(device) -> str | None:
    """The card's power limit as nvidia-smi prints it (e.g. "700.00 W"), or
    None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={require(str(device)).index}", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
