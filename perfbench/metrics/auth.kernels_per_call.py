"""Device kernels an authentication's bootstrap call launches, from the
profiler's trace over the traced calls: the host's launch work a call."""

LAYER = "kernels"
UNIT = "kernels/call"
MOVES = "auth_s"


def read(r):
    t = r.trace
    if t is None or not t.calls or not t.kernels:
        return None
    return t.kernels / t.calls
