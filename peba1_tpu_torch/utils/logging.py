"""Structured JSON-lines events (counterpart of ``peba1_tpu/utils/logging.py``).

Every event is one line ``{"ts": ..., "event": ..., **fields}`` written to a
stream and/or a file, so that scripts and tools read the logs directly.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import IO, Iterator, Optional


class EventLog:
    """JSON-lines event emitter with wall-clock timers and counters."""

    def __init__(self, stream: Optional[IO[str]] = None, path: Optional[str] = None,
                 context: Optional[dict] = None):
        self._stream = stream
        self._file = open(path, "a") if path else None
        self._owns_file = self._file is not None
        self._context = dict(context or {})
        self.counters: dict[str, float] = {}

    def close(self) -> None:
        # A child shares its parent's file but does not own it.
        if self._file is not None and self._owns_file:
            self._file.close()
        self._file = None

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 6), "event": event, **self._context, **fields}
        line = json.dumps(rec, default=_jsonable)
        for out in (self._stream, self._file):
            # A sink closed by its owner is skipped, not an error.
            if out is not None and not getattr(out, "closed", False):
                out.write(line + "\n")
                out.flush()
        return rec

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    @contextlib.contextmanager
    def timer(self, event: str, **fields) -> Iterator[dict]:
        """Times a block and emits `event` with `seconds` on exit.  Yields a
        dict whose entries the block may fill; they are merged into the
        event (and win over `fields`)."""
        extra: dict = {}
        t0 = time.perf_counter()
        try:
            yield extra
        finally:
            dt = time.perf_counter() - t0
            self.log(event, **{"seconds": round(dt, 6), **fields, **extra})

    def child(self, **context) -> "EventLog":
        """Same sinks, extra bound context fields (the file stays the parent's)."""
        c = EventLog(stream=self._stream, context={**self._context, **context})
        c._file = self._file
        c._owns_file = False
        return c


def _jsonable(x):
    import numpy as np
    import torch

    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x.tolist()
    return str(x)


NULL_LOG = EventLog()  # no sinks: every call is a cheap no-op


def stderr_log(**context) -> EventLog:
    return EventLog(stream=sys.stderr, context=context)
