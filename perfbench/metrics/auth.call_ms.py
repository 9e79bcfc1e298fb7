"""Milliseconds an authentication spends a bootstrap call: the whole
requests' wall time (host clock, each ending in a synchronize) over their
bootstrap calls.  The per-call floor that one request's pace is set by."""

LAYER = "bootstrap"
UNIT = "ms"
MOVES = "auth_s"


def read(r):
    if not r.request_s or not r.bootstrap_calls:
        return None
    return 1e3 * sum(r.request_s) / r.bootstrap_calls
