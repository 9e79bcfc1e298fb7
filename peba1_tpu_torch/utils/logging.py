"""Structured JSON-lines events (counterpart of ``peba1_tpu/utils/logging.py``)
and the program's spans on the profiler's clock.

Every event is one line ``{"ts": ..., "event": ..., **fields}`` written to a
stream and/or a file, so that scripts and tools read the logs directly.

`span(name)` marks a stage of the program as the range ``peba1.<name>`` in
any running ``torch.profiler`` trace, beside the device kernels and runtime
calls on the same clock; nesting on the calling thread is its parent link.
With no profiler recording it is one shared no-op context: it allocates
nothing and never synchronizes.  The spans a bootstrap call opens:

  * ``peba1.prepare``, ``peba1.modswitch``, ``peba1.rotation``,
    ``peba1.extract``, ``peba1.keyswitch``: its five stages, siblings in
    that order (``backends``, ``gates``, ``ops/bootstrap``);
  * ``peba1.accumulator``: inside the rotation, the starting accumulator
    the kernels after it update in place (kernel 1, kernel 4 and the scan
    of steps; the whole-rotation kernels set it up themselves);
  * ``peba1.sync_copy``: each upload of host values to the device, a miss
    of the constants `utils.device.from_host` keeps there by value; on a
    card it goes through pinned memory and does not wait for the stream, and
    a warmed call makes none;
  * ``peba1.kernel.<wrapper>``: each call of a wrapper of
    ``ops/cuda_kernels`` (checks, workspaces, launch; the plain twin on a
    CPU tensor).

``Server.identify_argmin`` opens two around its bootstrap calls:
``peba1.identify.distance`` (the distances, ``circuits.euclidean``) and
``peba1.identify.argmin`` (the tournament, ``circuits.argmin_tree``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
import time
from typing import IO, Iterator, Optional

import torch

SPAN_PREFIX = "peba1."
NO_SPAN = contextlib.nullcontext()     # what `span` returns with no profiler on

_profiler_enabled = torch.autograd._profiler_enabled
_record_function = torch.profiler.record_function


def span(name: str):
    """The range ``peba1.<name>`` while a profiler records, else `NO_SPAN`."""
    if _profiler_enabled():
        return _record_function(SPAN_PREFIX + name)
    return NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    label = SPAN_PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _profiler_enabled():
                with _record_function(label):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


class EventLog:
    """JSON-lines event emitter with wall-clock timers."""

    def __init__(self, stream: Optional[IO[str]] = None, path: Optional[str] = None,
                 context: Optional[dict] = None):
        self._stream = stream
        self._file = open(path, "a") if path else None
        self._owns_file = self._file is not None
        self._context = dict(context or {})

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

    @contextlib.contextmanager
    def timer(self, event: str, **fields) -> Iterator[dict]:
        """Times a block and emits `event` with `seconds` on exit.  Yields a
        dict whose entries the block may fill; they are merged into the
        event (and win over `fields`).  The block runs inside `span(event)`."""
        extra: dict = {}
        t0 = time.perf_counter()
        try:
            with span(event):
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

    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x.tolist()
    return str(x)


NULL_LOG = EventLog()  # no sinks: every call is a cheap no-op


def stderr_log(**context) -> EventLog:
    return EventLog(stream=sys.stderr, context=context)
