"""Atomic JSON writes (counterpart of ``peba1_tpu/utils/artifacts.py``).

A file rewritten as a checkpoint must never be left truncated by a kill
mid-write: write a temporary file, then rename it over the old one.
"""

from __future__ import annotations

import json
import os


def atomic_json(path: str, obj, indent: int | None = 1) -> None:
    """Write `obj` as JSON to `path` atomically (tmp file + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(tmp, path)
