"""Plain TFHE gate bootstrapping with exact torus arithmetic, from raw keys.

The benchmark's yardstick for the bootstrap layer: written from the TFHE
papers (Chillotti, Gama, Georgieva, Izabachene, J. Cryptology 2020), in plain
PyTorch, for any device.  It reads only the configuration's numbers and the
raw key material the benchmark made (binary keys, the TRGSW bootstrapping key
and the LWE keyswitching key as torus32 integers); whatever a program derives
from them, this module works out again.

Torus elements are held as int64 tensors with values in [0, 2^32).  Every
product runs as one float64 matrix product whose partial sums are integers
below 2^53, so it is exact whatever order the library sums in:
  * external product: |digit| <= Bg/2 <= 2^7, |key| < 2^31, (k+1)*l*N <= 2^12
    terms: below 2^50;
  * keyswitch: digit < 2^ks_basebit, key < 2^32, k*N*ks_t terms;
`_check_exact` refuses a configuration for which either bound fails;
  * key products of a binary key: n or k*N terms below 2^32.

The lattice semantics are the configuration's: signed gadget digits in
[-Bg/2, Bg/2) with a round-to-nearest offset, the body column of the
bootstrapping key rounded to its top `bk_body_limbs` bytes (round half up),
the mask columns to their top `bk_limbs` bytes, and the keyswitch digits of
TFHE v1.x with its rounding offset.
"""

from __future__ import annotations

import dataclasses

import torch

MASK32 = (1 << 32) - 1
MU_1_8 = 1 << 29          # +1/8 of the torus
MU_1_4 = 1 << 30          # +1/4

# Two-input gates of TFHE's gate-bootstrapping API: bootstrap(wa*a + wb*b +
# offset) to +-1/8, and the Boolean function it computes.
GATES = {
    "AND": (1, 1, -MU_1_8, lambda a, b: a & b),
    "OR": (1, 1, MU_1_8, lambda a, b: a | b),
    "NAND": (-1, -1, MU_1_8, lambda a, b: 1 - (a & b)),
    "NOR": (-1, -1, -MU_1_8, lambda a, b: 1 - (a | b)),
    "XOR": (2, 2, MU_1_4, lambda a, b: a ^ b),
    "XNOR": (-2, -2, -MU_1_4, lambda a, b: 1 - (a ^ b)),
    "ANDNY": (-1, 1, -MU_1_8, lambda a, b: (1 - a) & b),
    "ANDYN": (1, -1, -MU_1_8, lambda a, b: a & (1 - b)),
    "ORNY": (-1, 1, MU_1_8, lambda a, b: (1 - a) | b),
    "ORYN": (1, -1, MU_1_8, lambda a, b: a | (1 - b)),
}


@dataclasses.dataclass(frozen=True)
class Lattice:
    """The numbers of a configuration's `tfhe` group that the scheme reads."""

    n: int
    N: int
    k: int
    l: int
    bgbit: int
    ks_t: int
    ks_basebit: int
    bk_limbs: int
    bk_body_limbs: int
    lwe_stdev: float
    tlwe_stdev: float

    @classmethod
    def of(cls, tfhe: dict) -> "Lattice":
        return cls(**{f.name: tfhe[f.name] for f in dataclasses.fields(cls)})

    @property
    def G(self) -> int:
        """Rows of a TRGSW sample: (k+1) components times l digits."""
        return (self.k + 1) * self.l

    def with_body_limbs(self, limbs: int) -> "Lattice":
        return dataclasses.replace(self, bk_body_limbs=limbs)


@dataclasses.dataclass
class Keys:
    """Raw key material, int32 tensors on one device.

    lwe_key (n,) bits; tlwe_key (k, N) bits; bk (n, G, k+1, N) torus32, row
    u*l + p of step i a TRLWE encryption of zero plus s_i * 2^(32-(p+1)*bgbit)
    on component u's constant coefficient; ks (k*N, ks_t, n+1) torus32, entry
    (i, j) an LWE encryption (mask | body) of tlwe_key[i] * 2^(32-(j+1)*basebit).
    """

    lwe_key: torch.Tensor
    tlwe_key: torch.Tensor
    bk: torch.Tensor
    ks: torch.Tensor


def u32(x: torch.Tensor) -> torch.Tensor:
    """Torus32 values of an integer tensor, as int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def signed(x: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) -> the same torus element in [-2^31, 2^31)."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _exact_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Integer product through float64; exact below 2^53 (module docstring)."""
    return torch.matmul(x.to(torch.float64), y.to(torch.float64)).round().to(torch.int64)


def _check_exact(lat: Lattice) -> None:
    ext = (1 << (lat.bgbit - 1)) * (1 << 31) * lat.G * lat.N
    ks = ((1 << lat.ks_basebit) - 1) * (1 << 32) * lat.k * lat.N * lat.ks_t
    if max(ext, ks) >= 1 << 53:
        raise ValueError(f"{lat}: a product would leave float64's exact range")


def negacyclic_matrix(q: torch.Tensor) -> torch.Tensor:
    """M with p @ M = p * q mod X^N + 1 for row vectors p: (..., N) -> (..., N, N),
    M[t, j] = q[(j - t) mod N], negated where j < t."""
    N = q.shape[-1]
    t = torch.arange(N, device=q.device)[:, None]
    j = torch.arange(N, device=q.device)[None, :]
    m = q[..., (j - t) % N]
    return torch.where(j >= t, m, -m)


def key_product(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum_u key_u * a_u mod X^N + 1 for a binary key (k, N) and torus
    polynomials a (..., k, N); returns (..., N) in [0, 2^32)."""
    k, N = key.shape
    m = negacyclic_matrix(key.to(torch.int64)).reshape(k * N, N)
    return _exact_matmul(signed(u32(a)).reshape(a.shape[:-2] + (k * N,)), m) & MASK32


def dot_key(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """<a, key> mod 2^32: (..., n) torus x (n,) bits -> (...,)."""
    return _exact_matmul(signed(u32(a)), key.to(torch.int64)) & MASK32


def round_to_limbs(x: torch.Tensor, limbs: int) -> torch.Tensor:
    """x rounded (half up) to its top `limbs` bytes, mod 2^32."""
    if limbs >= 4:
        return u32(x)
    drop = 8 * (4 - limbs)
    return (u32(x) + (1 << (drop - 1))) & (MASK32 ^ ((1 << drop) - 1))


def bootstrapping_key(lat: Lattice, bk: torch.Tensor) -> torch.Tensor:
    """The key as the external product uses it: each output column rounded to
    its limbs (k mask columns, then the body), as signed torus32 (n, G, k+1, N)."""
    cols = [round_to_limbs(bk[:, :, o], lat.bk_limbs if o < lat.k else lat.bk_body_limbs)
            for o in range(lat.k + 1)]
    return signed(torch.stack(cols, dim=2))


def modswitch(x: torch.Tensor, N: int) -> torch.Tensor:
    """Torus32 -> Z_2N, rounded to nearest: round(x * 2N / 2^32) mod 2N."""
    shift = 32 - (2 * N).bit_length() + 1
    return ((u32(x) + (1 << (shift - 1))) >> shift) & (2 * N - 1)


def rotate(p: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """X^amt * p mod X^N + 1, rowwise: p (R, ..., N) in [0, 2^32), amt (R,)."""
    N = p.shape[-1]
    t = torch.arange(N, device=p.device)
    src = (t - amt.view((-1,) + (1,) * (p.dim() - 1))) % (2 * N)
    src = src.expand(p.shape)
    val = torch.gather(p, -1, src % N)
    return torch.where(src < N, val, (-val) & MASK32)


def gadget_digits(lat: Lattice, x: torch.Tensor) -> torch.Tensor:
    """Signed digits in [-Bg/2, Bg/2) of x (..., N), rounded to nearest:
    (..., l, N) with sum_p d_p * 2^(32-(p+1)*bgbit) = x to l*bgbit bits."""
    half = 1 << (lat.bgbit - 1)
    offset = 1 << (32 - lat.l * lat.bgbit - 1)
    for p in range(1, lat.l + 1):
        offset += half << (32 - p * lat.bgbit)
    v = (x + offset) & MASK32
    digits = [((v >> (32 - p * lat.bgbit)) & ((1 << lat.bgbit) - 1)) - half
              for p in range(1, lat.l + 1)]
    return torch.stack(digits, dim=-2)


def external_product(lat: Lattice, acc: torch.Tensor, key_step: torch.Tensor) -> torch.Tensor:
    """Digits of acc (R, k+1, N) times one TRGSW sample (G, k+1, N) signed:
    (R, k+1, N) in [0, 2^32)."""
    R, N = acc.shape[0], lat.N
    d = gadget_digits(lat, acc).reshape(R, lat.G * N)            # row (u, p, t)
    w = negacyclic_matrix(key_step)                              # (G, k+1, N_t, N_j)
    w = w.permute(0, 2, 1, 3).reshape(lat.G * N, (lat.k + 1) * N)
    return (_exact_matmul(d, w) & MASK32).view(R, lat.k + 1, N)


def blind_rotate(lat: Lattice, key: torch.Tensor, bara: torch.Tensor,
                 barb: torch.Tensor, mu: int) -> torch.Tensor:
    """X^(-barb) * (0, ..., 0, mu...mu), then n CMUX steps
    acc += ExtProd(key_i, X^bara_i * acc - acc).  key: `bootstrapping_key`."""
    R, N = bara.shape[0], lat.N
    acc = torch.zeros((R, lat.k + 1, N), dtype=torch.int64, device=bara.device)
    test_vector = torch.full((R, N), mu & MASK32, dtype=torch.int64, device=bara.device)
    acc[:, lat.k] = rotate(test_vector, (2 * N - barb) % (2 * N))
    for i in range(lat.n):
        diff = (rotate(acc, bara[:, i]) - acc) & MASK32
        acc = (acc + external_product(lat, diff, key[i])) & MASK32
    return acc


def sample_extract(lat: Lattice, acc: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The constant coefficient of acc (R, k+1, N) as an LWE sample under the
    flattened ring key: a[u*N] = a_u[0], a[u*N + j] = -a_u[N - j]."""
    mask = acc[:, :lat.k]
    flipped = torch.cat([mask[..., :1], (-mask[..., 1:].flip(-1)) & MASK32], dim=-1)
    return flipped.reshape(acc.shape[0], lat.k * lat.N), acc[:, lat.k, 0]


def keyswitch(lat: Lattice, ks: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """TFHE v1.x key switch k*N -> n: digits of a in base 2^basebit after
    the rounding offset, (a, b) = (0, b) - sum_ij digit_ij * ks[i, j]."""
    base = 1 << lat.ks_basebit
    v = (a + (1 << (32 - (1 + lat.ks_basebit * lat.ks_t)))) & MASK32
    shifts = torch.tensor([32 - (j + 1) * lat.ks_basebit for j in range(lat.ks_t)],
                          device=a.device)
    digits = ((v[..., None] >> shifts) & (base - 1)).reshape(a.shape[0], -1)
    acc = _exact_matmul(digits, u32(ks).reshape(-1, lat.n + 1)) & MASK32
    return (-acc[:, :lat.n]) & MASK32, (b - acc[:, lat.n]) & MASK32


def bootstrap_wo_ks(lat: Lattice, key: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    mu: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Blind rotation of (a (R, n), b (R,)) and sample extraction."""
    acc = blind_rotate(lat, key, modswitch(a, lat.N), modswitch(b, lat.N), mu)
    return sample_extract(lat, acc)


def bootstrap(lat: Lattice, keys: Keys, a: torch.Tensor, b: torch.Tensor,
              mu: int = MU_1_8, key: torch.Tensor | None = None):
    """Gate bootstrap of LWE samples (a (R, n), b (R,)) to +-mu by the sign
    of their phase, key-switched back to the small key.  `key` is
    `bootstrapping_key(lat, keys.bk)`, passed to reuse it."""
    _check_exact(lat)
    key = bootstrapping_key(lat, keys.bk) if key is None else key
    a_ext, b_ext = bootstrap_wo_ks(lat, key, u32(a), u32(b), mu)
    return keyswitch(lat, keys.ks, a_ext, b_ext)


def lincomb(name: str, a, b):
    """The linear combination before a two-input gate's bootstrap:
    (a, b) LWE pairs of (mask, body) tensors -> the combined pair."""
    wa, wb, off, _ = GATES[name]
    return ((wa * u32(a[0]) + wb * u32(b[0])) & MASK32,
            (wa * u32(a[1]) + wb * u32(b[1]) + off) & MASK32)


def gate(lat: Lattice, keys: Keys, name: str, a, b, key=None):
    """A bootstrapped two-input gate on LWE pairs (mask, body)."""
    return bootstrap(lat, keys, *lincomb(name, a, b), MU_1_8, key)


def mux(lat: Lattice, keys: Keys, a, b, c, key=None):
    """TFHE's bootsMUX, a ? b : c: the bootstraps of a AND b and of
    (not a) AND c without key switch, added, plus 1/8, then one key switch."""
    _check_exact(lat)
    key = bootstrapping_key(lat, keys.bk) if key is None else key
    a1, b1 = bootstrap_wo_ks(lat, key, (u32(a[0]) + u32(b[0])) & MASK32,
                             (u32(a[1]) + u32(b[1]) - MU_1_8) & MASK32, MU_1_8)
    a2, b2 = bootstrap_wo_ks(lat, key, (u32(c[0]) - u32(a[0])) & MASK32,
                             (u32(c[1]) - u32(a[1]) - MU_1_8) & MASK32, MU_1_8)
    return keyswitch(lat, keys.ks, (a1 + a2) & MASK32, (b1 + b2 + MU_1_8) & MASK32)


def phase(keys: Keys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - <a, s> under the small key, in [-2^31, 2^31)."""
    return signed((u32(b) - dot_key(a, keys.lwe_key)) & MASK32)


def decrypt_bits(keys: Keys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gate-bootstrapping decryption: 1 where the phase is positive."""
    return (phase(keys, a, b) > 0).to(torch.int64)
