"""Seconds an identification's bootstrap calls take on the device: the CUDA
event pair around each call of the window's whole requests, summed, over
their number.  Against `auth_s`, the time a request spends outside its
calls' streams."""

LAYER = "kernels"
UNIT = "s"
MOVES = "auth_s"


def read(r):
    if not r.request_s or not r.call_ms:
        return None
    return 1e-3 * sum(r.call_ms) / len(r.request_s)
