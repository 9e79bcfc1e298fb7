"""The device a tool runs on, and what its records say of it.

A tool runs on the card unless the caller asks for the CPU; a request for
the card on a machine without one fails, it never falls back.
"""

from __future__ import annotations

import subprocess

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


def from_host(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values (Python numbers, a list, a numpy array) as a new tensor on
    `device`.  To a card this is a copy from pageable memory, which waits
    for the stream: the span ``peba1.sync_copy`` names it in a trace."""
    with span("sync_copy"):
        return torch.as_tensor(values, dtype=dtype, device=device)


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
