"""Gate-execution backends for the circuit layer (counterpart of
``peba1_tpu/backends.py``).

  * CipherBackend -- real bootstrapped gates; the gates of one circuit level
    run as ONE batched bootstrap (`level`);
  * ClearBackend -- plaintext 0/1 int32 tensors, the same circuits;
  * CountingBackend -- ClearBackend that counts the bootstrap calls and
    bootstraps the cipher backend would run;
  * Tally -- any backend, its bootstrap calls and their bootstraps counted
    into a dict from the operands' shapes alone.

Both count by one rule, `call_bootstraps`.
"""

from __future__ import annotations

import math

import torch

from . import gates, lwe
from .keys import CloudKey
from .ops import bootstrap as bs
from .utils.device import from_host
from .utils.logging import span

# gate name -> (wa, wb, offset) for the lincomb bootstrap (cipher),
# and the boolean function (clear).
_GATE_LIN = {
    "AND": (1, 1, -gates.MU_1_8),
    "OR": (1, 1, gates.MU_1_8),
    "NAND": (-1, -1, gates.MU_1_8),
    "NOR": (-1, -1, -gates.MU_1_8),
    "XOR": (2, 2, gates.MU_1_4),
    "XNOR": (-2, -2, -gates.MU_1_4),
    "ANDNY": (-1, 1, -gates.MU_1_8),
    "ANDYN": (1, -1, -gates.MU_1_8),
    "ORNY": (-1, 1, gates.MU_1_8),
    "ORYN": (1, -1, gates.MU_1_8),
}

_GATE_FN = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b),
    "NOR": lambda a, b: 1 - (a | b),
    "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: 1 - (a ^ b),
    "ANDNY": lambda a, b: (1 - a) & b,
    "ANDYN": lambda a, b: a & (1 - b),
    "ORNY": lambda a, b: (1 - a) | b,
    "ORYN": lambda a, b: a | (1 - b),
}


class CipherBackend:
    """Executes gates homomorphically under a cloud key."""

    is_cipher = True

    def __init__(self, ck: CloudKey):
        self.ck = ck
        self.launches = 0  # bootstrap launch counter

    def gate(self, name: str, a, b):
        wa, wb, off = _GATE_LIN[name]
        self.launches += 1
        return gates.lincomb_bootstrap(self.ck, a, b, wa, wb, off)

    def __getattr__(self, name):
        if name in _GATE_LIN:
            return lambda a, b: self.gate(name, a, b)
        raise AttributeError(name)

    def NOT(self, a):
        return -a

    def MUX(self, a, b, c):
        self.launches += 1
        return gates.MUX(self.ck, a, b, c)

    def CONSTANT(self, value, shape=()):
        return gates.CONSTANT(self.ck, value, shape)

    def level(self, ops):
        """ops: list of (name, a, b) at the same circuit depth -> list of results.

        All gates execute as ONE bootstrap: inputs are stacked along a new
        leading axis and each gate's (wa, wb, offset) broadcasts over it.
        """
        with span("prepare"):
            shape = tuple(torch.broadcast_shapes(
                *[x.shape for _, a, b in ops for x in (a, b)]))
            L = len(ops)
            w = from_host([_GATE_LIN[name] for name, _, _ in ops], torch.int32,
                          self.ck.device)
            w = w.reshape((L, 3) + (1,) * len(shape))
            wa, wb, off = w[:, 0], w[:, 1], w[:, 2]
            A = lwe.stack([gates.expand(a, shape) for _, a, _ in ops])
            B = lwe.stack([gates.expand(b, shape) for _, _, b in ops])
            pre = lwe.Lwe(A.a * wa[..., None] + B.a * wb[..., None],
                          A.b * wa + B.b * wb + off)
            pre = gates.flatten(pre)
        self.launches += 1
        out = bs.bootstrap(self.ck, pre, gates.MU_1_8)
        res = gates.unflatten(out, (L,) + shape)
        return [res[i] for i in range(L)]

    def stack(self, xs, axis=0):
        return lwe.stack(xs, axis=axis)

    def concat(self, xs, axis=0):
        return lwe.concatenate(xs, axis=axis)


class ClearBackend:
    """Executes the same circuits on plaintext bit tensors (int32 0/1)."""

    is_cipher = False

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.launches = 0

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def gate(self, name: str, a, b):
        return _GATE_FN[name](self._t(a), self._t(b)).to(torch.int32)

    def __getattr__(self, name):
        if name in _GATE_FN:
            return lambda a, b: self.gate(name, a, b)
        raise AttributeError(name)

    def NOT(self, a):
        return 1 - self._t(a)

    def MUX(self, a, b, c):
        return torch.where(self._t(a) != 0, self._t(b), self._t(c))

    def CONSTANT(self, value, shape=()):
        return self._t(value).expand(tuple(shape))

    def level(self, ops):
        return [self.gate(name, a, b) for name, a, b in ops]

    def stack(self, xs, axis=0):
        return torch.stack([self._t(x) for x in xs], dim=axis)

    def concat(self, xs, axis=0):
        return torch.cat([self._t(x) for x in xs], dim=axis)


def call_bootstraps(per_element: int, operands) -> int:
    """The bootstraps one batched bootstrap call runs: `per_element` (a
    lincomb gate 1, a MUX 2, a fused level its number of gates) times the
    broadcast of its operands' batch shapes."""
    shape = torch.broadcast_shapes(*(tuple(x.shape) for x in operands))
    return per_element * math.prod(shape)


class CountingBackend(ClearBackend):
    """ClearBackend that also counts the bootstrap calls (`launches`) and
    the gate bootstraps the CipherBackend would execute for the same
    circuit run, by `call_bootstraps`."""

    def __init__(self, device="cpu"):
        super().__init__(device)
        self.bootstraps = 0

    def _count(self, per_element, operands) -> None:
        self.launches += 1
        self.bootstraps += call_bootstraps(per_element, [self._t(x) for x in operands])

    def gate(self, name, a, b):
        self._count(1, (a, b))
        return super().gate(name, a, b)

    def MUX(self, a, b, c):
        self._count(2, (a, b, c))
        return super().MUX(a, b, c)

    def level(self, ops):
        self._count(len(ops), [x for _, a, b in ops for x in (a, b)])
        # The BASE gate method: self.gate would count the level twice.
        return [ClearBackend.gate(self, name, a, b) for name, a, b in ops]


class Tally:
    """`be` with its bootstrap calls counted into `counts`: each gate, MUX
    or level adds 1 to ``counts["calls"]`` and its `call_bootstraps` to
    ``counts["bootstraps"]``.  The counts come from the operands' shapes
    alone: no device work, no synchronize.  Everything else passes through
    to `be`."""

    def __init__(self, be, counts: dict):
        self.be = be
        self.counts = counts

    def __getattr__(self, name):
        if name in _GATE_LIN:
            return lambda a, b: self.gate(name, a, b)
        return getattr(self.be, name)

    def _add(self, per_element: int, operands) -> None:
        self.counts["calls"] += 1
        self.counts["bootstraps"] += call_bootstraps(per_element, operands)

    def gate(self, name, a, b):
        self._add(1, (a, b))
        return self.be.gate(name, a, b)

    def MUX(self, a, b, c):
        self._add(2, (a, b, c))
        return self.be.MUX(a, b, c)

    def level(self, ops):
        self._add(len(ops), [x for _, a, b in ops for x in (a, b)])
        return self.be.level(ops)
