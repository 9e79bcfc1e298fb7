"""The comparison that decides `correct`, and its control.

Every number compared is a count of disagreements with the plain reference
(`perfbench.reference`), whose limit is 0: the program's bootstrap is exact
integer arithmetic, so any difference is a fault.  The control is the
program's own lower-precision path (`perfbench.run.Run.program_config`):
the bootstrapping key's body held to one 8-bit limb fewer than the
configuration states, judged by the same reference at the stated precision.
"""

from __future__ import annotations

import dataclasses

import torch

from .reference import tfhe as ref

CHUNK_ROWS = 16384


@dataclasses.dataclass
class Check:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Reference:
    """The reference's gate bootstrap and MUX over many rows, in chunks, on
    one device."""

    def __init__(self, lat: ref.Lattice, keys: ref.Keys):
        self.lat = lat
        self.keys = keys
        self.key = ref.bootstrapping_key(self.lat, keys.bk)

    def bootstrap(self, a: torch.Tensor, b: torch.Tensor):
        """Gate bootstraps of rows (a (R, n), b (R,)) to +-1/8."""
        outs = [ref.bootstrap(self.lat, self.keys, a[s:s + CHUNK_ROWS], b[s:s + CHUNK_ROWS],
                              ref.MU_1_8, self.key) for s in range(0, a.shape[0], CHUNK_ROWS)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def mux(self, x, y, z):
        """bootsMUX over rows of three LWE pairs."""
        rows = x[0].shape[0]
        outs = [ref.mux(self.lat, self.keys, *[(c[0][s:s + CHUNK_ROWS], c[1][s:s + CHUNK_ROWS])
                                              for c in (x, y, z)], key=self.key)
                for s in range(0, rows, CHUNK_ROWS)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def lines(checks: "list[Check]") -> "list[str]":
    """The numbers compared, each beside its limit, for standard error."""
    return [f"check {c.name} {c.value} limit {c.limit} {'ok' if c.ok else 'FAILED'}"
            for c in checks]


def as_json(checks: "list[Check]") -> dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}
