"""Bootstraps of an identification's tournament: the program's own counter
of `circuits.argmin_tree` (`circuits.argmin_counts`, a MUX two), which the
traffic kind resets at the window's start, over the window's whole requests.
Read nothing where the program has no such counter."""

import sys

LAYER = "circuits"
UNIT = "bootstraps"
MOVES = "auth_s"


def read(r):
    circuits = sys.modules.get("peba1_tpu_torch.circuits")
    counts = getattr(circuits, "argmin_counts", None)
    if not r.request_s or not counts or not counts.get("bootstraps"):
        return None
    return counts["bootstraps"] / len(r.request_s)
