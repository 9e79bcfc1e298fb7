"""TFHE parameter sets, TPU-native.

A copy of ``peba1_tpu/params.py`` (dataclasses and math only): the JAX
package's ``__init__`` pulls in jax, so it cannot be imported from there.
Two presets are the port's own, with no JAX twin: ``tfhers_bool_gen``
(tfhe-rs's boolean default lattice) and its CPU twin ``toy_tfhers_bool``.
The kernel flags keep their names; ``ops/bootstrap.py`` says which of them
run on the card.

Reimplements the role of the reference's external parameter factory
``new_default_gate_bootstrapping_parameters(lambda)`` (called at
reference src/main.cpp:21) as frozen dataclasses.  The lambda=128 preset
mirrors the well-known TFHE v1.x defaults the reference binary runs with
(SURVEY.md section 2.2 E1): LWE n=630 / ks_stdev 2^-15, TRLWE N=1024 k=1 /
bk_stdev 2^-25, gadget l=3 Bg=2^7, keyswitch t=8 base 2^2.

All torus elements are represented as int32 ("torus32"): the real torus
R/Z scaled by 2^32, with native wrap-around arithmetic (SURVEY.md E2).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """Complete parameter set for the gate-bootstrapping TFHE scheme.

    Attributes:
      n: LWE (small) mask dimension.
      lwe_stdev: stdev (fraction of torus) of fresh LWE encryption noise under
        the small key (TFHE's ``ks_stdev``).
      N: TRLWE ring dimension; polynomials live in Z[X]/(X^N+1).
      k: TRLWE mask size (number of mask polynomials); TFHE default 1.
      tlwe_stdev: stdev of TRLWE/TRGSW encryption noise (TFHE's ``bk_stdev``).
      l: gadget decomposition length (digits per torus element).
      bgbit: log2 of the gadget base Bg.
      ks_t: keyswitch decomposition length.
      ks_basebit: log2 of the keyswitch decomposition base.
      max_stdev: maximum tolerable noise stdev for correct 1/4-msg-space
        decryption (used only by validation checks / noise tests).
      bk_limbs: number of balanced 8-bit limbs used for the MASK polynomials
        of the bootstrapping key in the int8 MXU external product.  Must stay
        4 (exact): rounding error in a mask polynomial is multiplied by the
        secret key polynomial when the phase is decrypted, amplifying its
        stdev by ~sqrt(N/2) (~x23 at N=1024) -- measured on-chip as a 10x
        noise blow-up and a >1% per-gate error rate (scripts/diag.py noise).
      bk_body_limbs: limbs for the BODY polynomial columns.  Body rounding
        error enters the phase directly (no key amplification): dropping the
        low byte (3 limbs) adds stdev ~2^-10 of a torus over n=630 CMUX
        steps, far below max_stdev, and saves (k+1-1)/((k+1)*4) of the MACs.
      ext_backend: external-product kernel: "toeplitz" (explicit negacyclic
        int8 matmul, fast on TPU) or "conv" (lax.conv formulation; reference
        implementation, ~50x slower inside the blind-rotation loop on TPU).
    """

    n: int
    lwe_stdev: float
    N: int
    k: int
    tlwe_stdev: float
    l: int
    bgbit: int
    ks_t: int
    ks_basebit: int
    max_stdev: float = 0.012467
    bk_limbs: int = 4
    bk_body_limbs: int = 4
    ext_backend: str = "toeplitz"
    # Fuse rotation+difference+decomposition into one Pallas VMEM pass
    # (vs log2(2N)+4 HBM round-trips); interpret-mode on non-TPU backends.
    use_pallas_rotate: bool = False
    # Run the ENTIRE blind rotation as one Pallas kernel (ops/pallas_kernels
    # .fused_blind_rotate): accumulator resident in VMEM across all n CMUX
    # steps, precomputed A-matrix weight stream, limb recombination folded
    # into the MXU epilogue.  Supersedes use_pallas_rotate when set.
    # Measured SLOWER than the scan-step path on v5e (it re-streams the
    # A-matrix key once per batch tile); kept as a tested alternative.
    use_fused_cmux: bool = False
    # Per-step external product as a Pallas GEMM with the limb recombination
    # fused into the epilogue (ops/pallas_kernels.extprod_recombine): the
    # (B, C*N) int32 limb-product intermediate -- 184 MB/step at B=8192 on
    # the t2 set, the dominant non-MXU HBM traffic of the unfused path --
    # stays in VMEM.  Requires the keygen-precomputed per-step Toeplitz key
    # form CloudKey.bk_w ((n, G*N, C*N) int8; ~10.9 GB on the t2 set).
    use_pallas_extprod: bool = False
    # One whole CMUX step (rotate + decompose + GEMM + recombine +
    # accumulate) as a single Pallas kernel with the accumulator aliased
    # in place (ops/pallas_kernels.cmux_step): neither the digit matrix nor
    # the recombined delta ever leaves VMEM.  Requires bk_w unless
    # w_streaming is set.  Supersedes use_pallas_rotate/use_pallas_extprod.
    use_fused_step: bool = False
    # Assemble each step's Toeplitz weight matrix IN-GRAPH from the small
    # (n, G, C, 2N) generator instead of precomputing the O(n*G*N*C*N) bk_w
    # at keygen: trades ~2 extra HBM passes over one step's W (build-write +
    # GEMM-read, amortized against the GEMM FLOPs) for an n*N^2-factor
    # smaller key.  This is what makes the fused-step kernel usable where
    # bk_w cannot exist: 18.5 GB at the k=1 lambda=128 set, ~137 GB at
    # RING_2048 (BASELINE config 4).  Only meaningful with use_fused_step.
    w_streaming: bool = False
    # One whole CMUX step as a single Pallas kernel with the step's Toeplitz
    # weights assembled IN VMEM from the small doubled generator (bk_tp) by
    # strided-roll fine shifts (ops/pallas_kernels.cmux_step_gen): W never
    # exists in HBM at all.  The only fused-step option at RING_2048 (one
    # step's W ~134 MB exceeds VMEM so cmux_step cannot block it, and the
    # w_streaming scan branch materializes W in HBM in-graph); also removes
    # cmux_step's O(n*N^2) bk_w key everywhere else.  Supersedes
    # use_fused_step/w_streaming when set.
    use_gen_step: bool = False
    # The WHOLE blind rotation as one kernel (pallas_kernels
    # .blind_rotate_gen_full): generator key AND accumulator VMEM-resident
    # across all n steps, weights assembled in VMEM per step -- removes the
    # per-step accumulator HBM round-trip (~2*(k+1)*N*B*4*n bytes/batch) and
    # n-1 of the n kernel launches.  Requires the full bk_tp
    # (n*G*C*2N int8) to fit in VMEM next to the tile working set: true for
    # the N<=1024 lambda=128 family (36-41 MB), NOT for RING_2048 (134 MB,
    # which stays on use_gen_step).  Supersedes use_gen_step when set.
    use_gen_full: bool = False
    # Fine-shift block K of the precomputed A-matrix (ops/poly.prepare_amat):
    # per-step storage is C*G*K*(N + (N/K - 1)*K) int8, and each of the C
    # limb columns needs N/K MXU dots whose int32 outputs are VPU-summed --
    # larger K = fewer epilogue adds but a bigger HBM key (K=256 at
    # peba1_128_fast: 8.1 GB, U=4; K=128: 4.3 GB, U=8).  Must divide N and
    # be a multiple of 128 (lane-aligned weight slices).
    amat_block: int = 128


    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit

    @property
    def limb_plan(self) -> "tuple[int, ...]":
        """Per-output-polynomial limb counts for the external product:
        k mask polys (exact) then the body poly (possibly truncated)."""
        return (self.bk_limbs,) * self.k + (self.bk_body_limbs,)

    @property
    def big_n(self) -> int:
        """Dimension of the extracted LWE ciphertext (= k*N)."""
        return self.k * self.N

    @property
    def log2_2N(self) -> int:
        return int(math.log2(2 * self.N))

    def __post_init__(self):
        assert self.N & (self.N - 1) == 0, "N must be a power of two"
        assert 1 <= self.bk_body_limbs <= self.bk_limbs <= 4
        assert self.bgbit * self.l <= 32
        assert self.ks_basebit * self.ks_t <= 32
        # int8 exactness bound for the MXU external product:
        # contraction of (k+1)*l*N terms of digit(<=2^(bgbit-1)) * limb(<=2^7)
        bound = (self.k + 1) * self.l * self.N * (1 << (self.bgbit - 1)) * 128
        assert bound < 2**31, "external-product int32 accumulation would overflow"
        assert self.amat_block % 128 == 0 and (
            self.N % self.amat_block == 0 or self.amat_block >= self.N), \
            "amat_block must be a 128-multiple dividing N"
        # w_streaming only modifies the fused-step scan body; without
        # use_fused_step it would silently combine with use_pallas_extprod
        # into a keyset whose active form (bk_w) keygen never builds --
        # fail here, not two modules later inside blind_rotate.
        assert not self.w_streaming or self.use_fused_step, \
            "w_streaming is only meaningful with use_fused_step"


# TFHE v1.x gate-bootstrapping defaults for minimum_lambda <= 128, the set the
# reference binary uses (src/main.cpp:20-21 passes lambda=128).
PEBA1_128 = TfheParams(
    n=630,
    lwe_stdev=2.0**-15,
    N=1024,
    k=1,
    tlwe_stdev=2.0**-25,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Larger-ring set for BASELINE.json config 4 (N=2048, higher security margin).
# Digits are +-128 with bgbit=8, still int8-representable; the int32
# accumulation bound (k+1)*l*N*128*128 = 2^30.6 still holds.
RING_2048 = TfheParams(
    n=1024,
    lwe_stdev=2.0**-17,
    N=2048,
    k=1,
    tlwe_stdev=2.0**-28,
    l=2,
    bgbit=8,
    ks_t=8,
    ks_basebit=2,
)

# Tiny parameters for fast CPU tests.  Noise-free (stdev 0) so that every
# pipeline stage is exactly deterministic; modswitch rounding is the only
# "noise", and with n=32, N=128 its typical magnitude (~sqrt(n)/(4N*sqrt(3)))
# is far below the 1/16 decoding margin.
TOY = TfheParams(
    n=32,
    lwe_stdev=0.0,
    N=128,
    k=1,
    tlwe_stdev=0.0,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Toy set with realistic-shaped (but scaled) noise for noise-growth tests.
TOY_NOISY = TfheParams(
    n=32,
    lwe_stdev=2.0**-15,
    N=128,
    k=1,
    tlwe_stdev=2.0**-25,
    l=3,
    bgbit=7,
    ks_t=8,
    ks_basebit=2,
)

# Throughput-tuned variant of the lambda=128 set.  Three levers, same
# security (n, N, key distributions, encryption noise unchanged):
#   * l=2 / Bg=2^8 gadget: (k+1)*l = 4 digit rows instead of 6 (-33% MXU
#     MACs).  Requires the round-to-nearest gadget offset
#     (ops/decompose.gadget_offset) -- with TFHE's biased truncation this
#     gadget mis-decodes ~5%/gate; with rounding, measured on-chip
#     post-bootstrap phase noise is sigma = 0.0051 against the 1/16 decoding
#     margin (12 sigma), 0 errors in 4096 (scripts/diag.py noise).
#   * body polynomial truncated to 3 limbs (-12.5% MACs): body rounding
#     error enters the phase directly (no key amplification), stdev ~2^-10;
#     the mask stays exact (its rounding error is key-convolved, x~sqrt(N/2),
#     measured to break decoding -- see TfheParams.bk_limbs).
#   * fused Pallas rotate+decompose kernel (one VMEM pass per CMUX step).
# Measured end-to-end: 5,121 bootstraps/s/chip at B=8192, chained
# correctness 100% (scripts/diag.py throughput l2_body3), vs 2,005 for
# PEBA1_128 with the XLA barrel rotate.
PEBA1_128_FAST = dataclasses.replace(
    PEBA1_128, l=2, bgbit=8, bk_body_limbs=3, use_pallas_rotate=True)

# TOY with the PEBA1_128_FAST levers (l=2/Bg=2^8 gadget, 3-limb body,
# Pallas rotate) so the fast configuration is exercisable end-to-end on CPU.
TOY_FAST = dataclasses.replace(
    TOY, l=2, bgbit=8, bk_body_limbs=3, use_pallas_rotate=True)

# Module-LWE throughput set: k=2 rank-2 module over N=512 instead of k=1 over
# N=1024.  Same total key dimension k*N = 1024, same key distribution
# (uniform binary) and same noise rates as PEBA1_128_FAST, so the MLWE
# instance is at least as hard as the k=1 RLWE instance of equal dimension
# (module structure interpolates from ring- toward plain LWE) -- lambda ~ 128
# like TFHE v1.x's N=1024 set.  Why it is faster on the MXU: external-product
# MACs scale as (k+1)*l*N x (k*mask_limbs + body_limbs)*N = 3072 x 5632 per
# step, 0.59x of the k=1 set's 4096 x 7168, and the per-step barrel rotation
# touches (k+1)*N = 1536 int32 lanes over log2(2N) = 10 stages (0.68x).  The
# price is modswitch rounding to Z_{2N} with N=512 (a-priori per-coefficient
# stdev sqrt(n/12)/(2N) = 0.0070 vs 0.0035 at N=1024).  The MEASURED
# steady-state chained-gate phase error is smaller than that estimate:
# sigma = 0.0051 against the 1/16 margin = 12.2 sigma, 0 errors and 0 chain
# corruptions in 1.05e7 chained gates, Gaussian per-gate bound 3e-34
# (NOISE_r03_t2.json -- the committed on-chip campaign artifact,
# scripts/diag.py campaign).
#
# Kernel choice (measured on v5e, B=8192, scripts/diag.py throughput):
#   plain XLA GEMM + Pallas rotate (t2_xla)             8,106 bs/s
#   + GEMM epilogue recombination (t2_extprod)          9,464 bs/s
#   single-kernel CMUX step, acc aliased (t2_step)     12,269 bs/s  <- this
#   whole-rotation fused kernel (t2_fused)              2,471 bs/s
# (the whole-rotation kernel re-streams the A-matrix key per batch tile and
# its per-tile dots are too skinny for the MXU).  All paths bit-identical
# (tests/test_fused.py); chain-correctness 100% on every measurement.
PEBA1_128_T2 = dataclasses.replace(
    PEBA1_128, k=2, N=512, l=2, bgbit=8, bk_body_limbs=3,
    use_pallas_rotate=True, use_fused_step=True)

# TOY-scale module set (k=2) so every MLWE code path runs on CPU.
TOY_T2 = dataclasses.replace(
    TOY, k=2, N=128, l=2, bgbit=8, bk_body_limbs=3,
    use_pallas_rotate=True, use_fused_step=True)

# Streaming-W variants: the fused-step CMUX kernel with each step's Toeplitz
# weights assembled in-graph from the small generator instead of the
# precomputed O(n*N^2) bk_w key (TfheParams.w_streaming).  Same math, a
# ~10.9-GB-smaller cloud key on the t2 set -- the right choice when the
# protocol working set (large ciphertext batches, 1:N template databases)
# must share HBM with the key -- and the ONLY fused-step option for the k=1
# lambda=128 family (its bk_w would be 18.5 GB).
PEBA1_128_T2_STREAM = dataclasses.replace(PEBA1_128_T2, w_streaming=True)
PEBA1_128_FAST_STREAM = dataclasses.replace(
    PEBA1_128_FAST, use_fused_step=True, w_streaming=True)

# Generator-streaming fused-step variants (TfheParams.use_gen_step): the
# per-step Toeplitz weights are assembled in VMEM inside the kernel from the
# small bk_tp generator -- no bk_w key AND no per-step W in HBM.  This is the
# BASELINE config-4 production path: at RING_2048, neither bk_w (~137 GB) nor
# an HBM-materialized per-step W (~134 MB inside a 1024-step scan; crashed
# the TPU-worker watchdog in the r03 attempt, runs/lever.log) is viable.
# Measured on v5e at B=8192, honest 2-vs-10-chain delta timing
# (scripts/diag.py throughput, r4 / LEVER_r04.json):
#   t2_gen    13,660 bs/s   (headline; vs 12,178 for bk_w-streaming
#                            cmux_step -- and no 10.9 GB bk_w key)
#   t2_genf   13,616 bs/s   (whole-rotation resident kernel: tied at k=2)
#   fast_gen   6,596 bs/s   (k=1 faithful-lattice family)
#   fast_genf  8,469 bs/s   (resident kernel wins +28% at k=1, where the
#                            per-step MXU work is smaller relative to the
#                            acc HBM round-trip it eliminates)
#   n2048_gen  1,358 bs/s   (BASELINE config 4: first on-chip N=2048 number;
#                            1.7x the best HBM-streaming alternative)
# For the t2/fast family the crypto parameters are IDENTICAL to the non-gen
# presets (only the kernel differs, and all kernels are bit-identical,
# tests/test_fused.py), so the NOISE_r03_t2 campaign certification carries
# over to t2_gen unchanged.  RING_2048_GEN is NOT a pure kernel swap: it
# additionally truncates the body polynomial to 3 limbs (bk_body_limbs=3, a
# noise-affecting key-truncation lever -- body rounding error enters the
# phase directly, stdev ~2^-10 over n=1024 CMUX steps, far below the
# decoding margin; see TfheParams.bk_body_limbs) and therefore carries its
# own noise campaign (NOISE_r05_n2048.json).
RING_2048_GEN = dataclasses.replace(
    RING_2048, bk_body_limbs=3, use_gen_step=True)
PEBA1_128_T2_GEN = dataclasses.replace(PEBA1_128_T2, use_gen_step=True)
PEBA1_128_FAST_GEN = dataclasses.replace(PEBA1_128_FAST, use_gen_step=True)
PEBA1_128_T2_GENF = dataclasses.replace(PEBA1_128_T2_GEN, use_gen_full=True)
PEBA1_128_FAST_GENF = dataclasses.replace(
    PEBA1_128_FAST_GEN, use_gen_full=True)

# tfhe-rs (Zama) v0.1 boolean DEFAULT_PARAMETERS (tfhe/src/boolean/parameters
# /mod.rs, https://github.com/zama-ai/tfhe-rs), its default 128-bit set for
# Boolean circuits on a 32-bit torus with uniform binary keys: lwe_dimension
# 722, glwe_dimension 2, polynomial_size 512, lwe_modular_std_dev
# 1.3071021089943935e-05, glwe_modular_std_dev 4.990272175010415e-08,
# pbs_base_log 6 / pbs_level 3, ks_base_log 3 / ks_level 4.  The published
# rank-2 module lattice at N=512 (G = (k+1)*l = 9 digit polynomials, C = 12
# limbs), run on kernel 1 (cmux_step_gen: one launch a call after the
# initial accumulator) with the bootstrapping key exact (4 limbs, mask and
# body).  One departure: the keyswitch digits are TFHE v1.x's unsigned
# digits in [0, 2^3) after its rounding offset (12 bits kept), where
# tfhe-rs decomposes signed -- the same shape and work, about 3x the
# keyswitch noise variance, most of it a constant offset of each key (the
# digits' mean 7/2 times the sum of the keyswitching key's noises; spread
# over keys ~0.0029).  Measured phase sigma about that offset: 0.0031
# against the 1/16 margin (H100_NOISE_tfhers_bool_gen.json).  Gadget digits
# are signed and rounded to nearest, as in tfhe-rs.
TFHERS_BOOL_GEN = TfheParams(
    n=722,
    lwe_stdev=1.3071021089943935e-05,
    N=512,
    k=2,
    tlwe_stdev=4.990272175010415e-08,
    l=3,
    bgbit=6,
    ks_t=4,
    ks_basebit=3,
    bk_limbs=4,
    bk_body_limbs=4,
    use_pallas_rotate=True,
    use_fused_step=True,
    use_gen_step=True,
)

# TFHERS_BOOL_GEN's twin for the CPU: the same k, gadget, keyswitch, limbs and
# kernel flags at n=32, N=128, noise-free like TOY.
TOY_TFHERS_BOOL = dataclasses.replace(
    TFHERS_BOOL_GEN, n=32, N=128, lwe_stdev=0.0, tlwe_stdev=0.0)

PRESETS = {
    "peba1_128": PEBA1_128,
    "peba1_128_fast": PEBA1_128_FAST,
    "peba1_128_fast_stream": PEBA1_128_FAST_STREAM,
    "peba1_128_fast_gen": PEBA1_128_FAST_GEN,
    "peba1_128_fast_genf": PEBA1_128_FAST_GENF,
    "peba1_128_t2": PEBA1_128_T2,
    "peba1_128_t2_stream": PEBA1_128_T2_STREAM,
    "peba1_128_t2_gen": PEBA1_128_T2_GEN,
    "peba1_128_t2_genf": PEBA1_128_T2_GENF,
    "ring_2048": RING_2048,
    "ring_2048_gen": RING_2048_GEN,
    "tfhers_bool_gen": TFHERS_BOOL_GEN,
    "toy": TOY,
    "toy_fast": TOY_FAST,
    "toy_t2": TOY_T2,
    "toy_noisy": TOY_NOISY,
    "toy_tfhers_bool": TOY_TFHERS_BOOL,
}


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """PEBA1 protocol-level constants (reference driver src/main.cpp:30-32,520).

    Attributes:
      nslots: embedding vector length (128 face-embedding slots).
      bitsize: significant bits per slot value.
      max_bitsize: accumulator width of the squared-Euclidean distance
        (hard-coded 24 in the reference, src/Math.cpp:342).
      mul_width: multiplier accumulator width (hard-coded 23 in the reference,
        src/Math.cpp:216).
      bound_match: squared-distance acceptance threshold
        (nslots*2 in the reference driver, src/main.cpp:520).
    """

    nslots: int = 128
    bitsize: int = 8
    max_bitsize: int = 24
    mul_width: int = 23
    bound_match: int = 256


PEBA1_PROTOCOL = ProtocolParams()
