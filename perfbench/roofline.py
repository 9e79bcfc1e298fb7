"""The least time a gate bootstrap call could take on one NVIDIA H100 in the
int8-limb Toeplitz formulation, from the configuration's shapes and stated
precision alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit:
1,979e12 int8 tensor-core operations a second (2 per multiply-add) and
3.35e12 bytes a second of HBM3.

The formulation is the one the port's rotation kernels compute (`KERNELS`):
each of the blind rotation's n external products as one dense int8 GEMM,
the (B, G*N) gadget digits times the (G*N, C*N) negacyclic Toeplitz weights
of one step, G = (k+1)*l digit rows and C = (k+1)*4 limbs, since each of the
key's k+1 components is a torus32, exact as the configuration states, held
as four 8-bit limbs.  The key switch is one (B, k*N*ks_t) digit matrix times
the keyswitching key's four limbs a torus32, (k*N*ks_t, (n+1)*4).  Bytes:
the generator key (n, G, C, 2N) int8 and the keyswitching table read once,
each LWE input and output (n+1 int32) once.

The count does not follow the program's limb levers (`bk_limbs`,
`bk_body_limbs`): a program told to hold fewer limbs does less work and is
not correct.  Nor is it a bound on the function: an NTT or FFT formulation
needs far fewer operations, so a call computed by a kernel outside `KERNELS`
is not measured against this count.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
TORUS_LIMBS = 4                   # 8-bit limbs of one exact torus32

# The port's kernels that compute the external product as this dense GEMM.
KERNELS = ("cmux_step_gen", "blind_rotate_gen_full", "cmux_step", "extprod_recombine",
           "fused_blind_rotate")


def _c(t: dict) -> int:
    return (t["k"] + 1) * TORUS_LIMBS


def _g(t: dict) -> int:
    return (t["k"] + 1) * t["l"]


def step_macs(t: dict, rows: int) -> int:
    """Multiply-adds of one CMUX step's external product over `rows` rows."""
    return rows * _g(t) * t["N"] * _c(t) * t["N"]


def keyswitch_macs(t: dict, rows: int) -> int:
    return rows * t["k"] * t["N"] * t["ks_t"] * (t["n"] + 1) * TORUS_LIMBS


def call_bytes(t: dict, rows: int) -> int:
    key = t["n"] * _g(t) * _c(t) * 2 * t["N"]
    table = t["k"] * t["N"] * t["ks_t"] * (t["n"] + 1) * TORUS_LIMBS
    return key + table + 2 * rows * (t["n"] + 1) * 4


def step_bound_s(t: dict, rows: int) -> float:
    """One CMUX step's least time (operations only: a step's share of the key
    is read by the call)."""
    return 2 * step_macs(t, rows) / INT8_OPS_PER_S


def call_bound_s(t: dict, rows: int) -> "tuple[float, str]":
    """A bootstrap call's least time, and what bounds it ("operations" or
    "bytes")."""
    ops = 2 * (t["n"] * step_macs(t, rows) + keyswitch_macs(t, rows)) / INT8_OPS_PER_S
    mem = call_bytes(t, rows) / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def formulation_ran(device_ops) -> bool:
    """Whether a traced slice's device operations ([[name, seconds], ...])
    include a kernel of this formulation."""
    return any(k in name for name, _ in device_ops for k in KERNELS)
