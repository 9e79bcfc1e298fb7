"""Hand-written CUDA kernels for Hopper, their build, binding and plain twins.

Six wrappers, each replacing one kernel of ``peba1_tpu/ops/pallas_kernels.py``
of the same name:

  * `cmux_step_gen`: whole CMUX steps with the Toeplitz weights formed on the
    fly from the generator key ``bk_tp``, all steps of a call in one launch
    (``csrc/cmux_step_gen.cu``);
  * `blind_rotate_gen_full`: the whole blind rotation, accumulator set-up and
    all n such steps, in one launch (``csrc/blind_rotate_gen_full.cu``);
  * `rotate_decompose`: rotate, difference and gadget digits in natural
    coefficient order, a persistent pass over whole rows fed and drained by
    bulk copies, its grid from `rotdec_plan` (``csrc/rotate_decompose.cu``);
  * `extprod_recombine`: digits times one step's precomputed weights W, limb
    recombination as the epilogue (``csrc/cmux_step.cu``);
  * `cmux_step`: CMUX steps against precomputed W, the product added into the
    accumulator, all steps of a call in one launch (``csrc/cmux_step.cu``);
  * `fused_blind_rotate`: the whole blind rotation against the precomputed
    A-matrix ``bk_amat``, in one launch (``csrc/fused_blind_rotate.cu``).

Design notes are in the sources.  Every kernel but `rotate_decompose` runs on
the skeleton of ``csrc/whole_rotation.cuh`` (wgmma on a TMA-fed
shared-memory ring; `cmux_step_gen` and `blind_rotate_gen_full` through
``csrc/gen_rotation.cuh``, which walk a step's work items by stage and take
no split; the other three split the contraction as `tile_plan` says);
`rotate_decompose` borrows only the header's mbarrier helpers.
On a CPU tensor a wrapper runs its plain twin (``*_plain``, the same
signature and result in plain PyTorch).  On a CUDA tensor it launches the
kernel or raises; it never falls back.  Every ``csrc/*.cu`` is compiled
with ``nvcc`` for ``sm_90a`` at first use into its own shared library, all
at once, under the package's ``build/`` directory (keyed by one hash of
every source and the flags; git ignores it), and bound with ctypes.
``launches`` counts the CUDA kernel launches each wrapper makes: one per
call for every wrapper; ``narrow_calls`` those of `cmux_step_gen` and
`blind_rotate_gen_full` that took the narrow step (``csrc/*_narrow.cu``, on
``csrc/narrow_rotation.cuh``), which they launch at `NARROW_MAX_ROWS` rows
or fewer.  Each wrapper call is the span
``peba1.kernel.<wrapper>`` in a profiler's trace (``utils/logging``).
Inside `record_phases`, `cmux_step_gen` and `blind_rotate_gen_full` launch
the instance of their kernel that records each step's phases
(``csrc/*_phases.cu``; ``step_phases`` reads the records); nothing else
turns it on.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..params import TfheParams
from ..utils.logging import spanned
from . import decompose as dec
from . import poly, rotate

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# C entry point -> (library, argument types); every one returns a CUDA error.
_ENTRIES = {
    "peba1_cmux_step_gen": ("cmux_step_gen", [_P] * 5 + [_I] * 6 + [_U, _I, _I, _P]),
    "peba1_blind_rotate_gen_full": ("blind_rotate_gen_full",
                                    [_P] * 5 + [_I] * 6 + [_U, _I, _I, _U, _P]),
    "peba1_cmux_step_gen_narrow": ("cmux_step_gen_narrow",
                                   [_P] * 5 + [_I] * 6 + [_U, _I, _I, _P]),
    "peba1_blind_rotate_gen_full_narrow": ("blind_rotate_gen_full_narrow",
                                           [_P] * 5 + [_I] * 6 + [_U, _I, _I, _U, _P]),
    "peba1_cmux_step_gen_phases": ("cmux_step_gen_phases",
                                   [_P] * 5 + [_I] * 6 + [_U, _I, _I, _P, _I, _I, _I, _P]),
    "peba1_blind_rotate_gen_full_phases": (
        "blind_rotate_gen_full_phases",
        [_P] * 5 + [_I] * 6 + [_U, _I, _I, _U, _P, _I, _I, _I, _P]),
    "peba1_rotate_decompose": ("rotate_decompose", [_P] * 3 + [_I] * 5 + [_U, _I, _I, _I, _P]),
    "peba1_extprod_recombine": ("cmux_step", [_P] * 3 + [_I] * 7 + [_P]),
    "peba1_cmux_step": ("cmux_step", [_P] * 5 + [_I] * 6 + [_U, _I, _I, _I, _P]),
    "peba1_fused_blind_rotate": ("fused_blind_rotate",
                                 [_P] * 5 + [_I] * 6 + [_U, _I, _I, _I, _I, _U, _P]),
}

launches = {"cmux_step_gen": 0, "blind_rotate_gen_full": 0, "rotate_decompose": 0,
            "extprod_recombine": 0, "cmux_step": 0, "fused_blind_rotate": 0}
# Of those, the launches of kernels 1 and 2 that took the narrow step.
narrow_calls = {"cmux_step_gen": 0, "blind_rotate_gen_full": 0}
_fns: dict = {}


def reset_launches() -> None:
    for counts in (launches, narrow_calls):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> "dict[str, Path]":
    """Compile every ``csrc/*.cu`` into its own shared library, one nvcc per
    source, all started together; cached under one hash of every source,
    header and flag.  Returns {source stem: library path}.  nvcc's
    ``-Xptxas -v`` report is kept beside each library as ``<stem>.ptxas.txt``."""
    tag = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        tag.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_DIR / tag.hexdigest()[:12]
    libs = {src.stem: out_dir / f"{src.stem}.so" for src in sorted(CSRC.glob("*.cu"))}
    if all(lib.exists() for lib in libs.values()):
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for stem in libs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        jobs[stem] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for stem, (tmp, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode == 0:
            (out_dir / f"{stem}.ptxas.txt").write_text(err)
            os.replace(tmp, libs[stem])
        else:
            failed.append(f"{stem}.cu: nvcc failed ({proc.returncode}):\n{err}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def _fn(name: str):
    if not _fns:
        libs = {stem: ctypes.CDLL(str(path)) for stem, path in build().items()}
        for entry, (stem, argtypes) in _ENTRIES.items():
            fn = getattr(libs[stem], entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _fns[entry] = fn
    return _fns[name]


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call a C entry point on `device`'s current stream; raise on its error.
    The entry launches on the current device, so it is switched to `device`
    only when it is another."""
    fn = _fn(entry)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def _check(kernel: str, p: TfheParams, **want) -> torch.device:
    """Each keyword is (tensor, dtype, shape); all on one device, contiguous.
    Returns the device.  On a non-CPU device, also what every kernel needs."""
    device = next(iter(want.values()))[0].device
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {dtype} of shape "
                             f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, not {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for {device}")
    if device.type == "cuda" and p.N % 64:
        raise ValueError(f"{kernel} kernel needs N % 64 == 0, got N={p.N}")
    return device


def _sizes(p: TfheParams) -> "tuple[int, int, int]":
    """(k+1, G = (k+1)l, C = sum of the limb plan)."""
    return p.k + 1, (p.k + 1) * p.l, sum(p.limb_plan)


def _step_args(p: TfheParams) -> tuple:
    return (p.N, p.k, p.l, p.bgbit, dec.gadget_offset(p), p.bk_limbs, p.bk_body_limbs)


# --- the tile plan of the kernels on csrc/whole_rotation.cuh ----------------

BM_ROWS = 128      # batch rows of one work item (two 64-row wgmma warpgroups)
BN_COLS = 64       # coefficients of one work item
BK_BYTES = 128     # contraction bytes of one shared-memory stage
RING_MAX_STAGES = 4                                              # MAX_STAGES
RING_STAGE_BYTES = BM_ROWS * BK_BYTES + 4 * BN_COLS * BK_BYTES   # STAGE_BYTES


UNIT_REFS, UNIT_REF_BYTES = 128, 32                              # gen_rotation.cuh


def gen_ring_stages(N: int, smem_per_block: int) -> int:
    """The ring depth of kernels 1 and 2 at ring degree N on a card whose
    blocks may opt in to `smem_per_block` bytes of shared memory
    (``whole_rotation.cuh``'s ``ring_stages`` beside ``gen_rotation.cuh``'s
    ``gen_extra``: two buffers of generator windows, N + 80 bytes a limb, up
    to four limbs, their two mbarriers and the table of UNIT_REFS units):
    at most RING_MAX_STAGES, 0 if not even two fit."""
    extra = 2 * 4 * (N + 80) + 16 + UNIT_REFS * UNIT_REF_BYTES
    for stages in range(RING_MAX_STAGES, 1, -1):
        if 1024 + stages * (RING_STAGE_BYTES + 16) + extra <= smem_per_block:
            return stages
    return 0


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernels on ``csrc/whole_rotation.cuh`` cut one CMUX step's
    GEMM: `tiles` = ceil(B/128) row tiles x (k+1) output polynomials x
    N/64 column tiles, each cut into `split` work items along the
    contraction's `blocks` blocks (the G*U (g, u) blocks of the A-matrix, or
    the G digit polynomials of the generator), a block `depth` stages of
    128 contraction bytes.

    The walk of the items over a grid of `grid` blocks: kernels 4 and 6
    hand them out round-robin; kernels 1 and 2 walk by stage (`pieces`),
    as ``whole_rotation.cuh``'s ``piece_at`` does."""

    split: int
    blocks: int
    tiles: int
    depth: int

    @property
    def items(self) -> int:
        """Work items of a step, split fastest (``item_at``)."""
        return self.tiles * self.split

    @property
    def stages(self) -> int:
        """Stages of one work item."""
        return self.blocks // self.split * self.depth

    def blocks_of(self, sp: int) -> range:
        """The contraction blocks of split `sp`, as the kernels walk them:
        block b is (g, u) = divmod(b, U) for the A-matrix, g for the
        generator."""
        per = self.blocks // self.split
        return range(sp * per, (sp + 1) * per)

    def tail_range(self, block: int, grid: int) -> range:
        """The stages of a step's tail that `block` takes: the items left
        after the full waves, as one run of stages in the order (item,
        stage), cut into `grid` contiguous ranges, the first (tail stages
        mod grid) of them one stage longer (``tail_range``)."""
        q, rem = divmod(self.items % grid * self.stages, grid)
        lo = block * q + min(block, rem)
        return range(lo, lo + q + (block < rem))

    def pieces(self, block: int, grid: int) -> "list[tuple[int, int, int]]":
        """(item, first stage, end stage) of every piece that `block` runs
        in a step walked by stage: its items of the full waves whole, as
        round-robin hands them out, then its tail range cut at the items'
        boundaries."""
        full, P = self.items // grid, self.stages
        out = [(block + w * grid, 0, P) for w in range(full)]
        tail = self.tail_range(block, grid)
        s = tail.start
        while s < tail.stop:
            r = s // P
            end = min(tail.stop, (r + 1) * P)
            out.append((full * grid + r, s - r * P, end - r * P))
            s = end
        return out

    def early_stages(self, block: int, grid: int, ring: int, rows: int) -> int:
        """The stages whose weight tiles `block`'s producer expands inside
        barrier 1 of a step walked by stage at `rows` rows, on a ring of
        `ring` stages (``gen_rotation.cuh``'s ``expand_early``): those of its
        first unit, its first piece up to the end of that piece's digit
        polynomial (`depth` stages), at most ring - 1, or one below a full
        row tile of BM_ROWS; 0 on an empty walk."""
        pieces = self.pieces(block, grid)
        if not pieces:
            return 0
        _, first, end = pieces[0]
        most = 1 if rows < BM_ROWS else ring - 1
        return min(most, min(end, (first // self.depth + 1) * self.depth) - first)

    def critical_stages(self, grid: int) -> int:
        """The most stages a block runs in a step walked by stage:
        floor(U/W)*P + ceil((U mod W)*P/W), which is ceil(U*P/W)."""
        return -(-self.items * self.stages // grid)

    def round_robin_stages(self, grid: int) -> int:
        """The most stages a block runs in a step walked round-robin."""
        return -(-self.items // grid) * self.stages


def contraction_blocks(params: TfheParams, kernel: str, K: int | None = None) -> int:
    """The blocks that a split of `kernel`'s contraction may take: G*U
    (g, u) blocks for fused_blind_rotate (U = N/K, K from
    ``params.amat_block`` unless given), G digit polynomials for the other
    four kernels on the skeleton."""
    G = (params.k + 1) * params.l
    if kernel == "fused_blind_rotate":
        K = K or poly.amat_geometry(params.N, params.amat_block)[0]
        return G * (params.N // K)
    if kernel in ("cmux_step_gen", "blind_rotate_gen_full", "cmux_step", "extprod_recombine"):
        return G
    raise ValueError(f"no tile plan for {kernel}")


# The kernels that walk a step's work items by stage (`TilePlan.pieces`);
# the others hand them out round-robin.
BY_STAGE = ("cmux_step_gen", "blind_rotate_gen_full")


def round_robin_split(tiles: int, blocks: int, sm_count: int) -> int:
    """The split that fills `sm_count` SMs when items are handed out
    round-robin: the least divisor S of the contraction's blocks that gives
    at least two work items per SM (every split adds its delta into acc with
    an atomic add, so fewer is cheaper), or all the blocks when even that is
    too few."""
    for s in range(1, blocks + 1):
        if blocks % s == 0 and tiles * s >= 2 * sm_count:
            return s
    return blocks


def tile_plan(B: int, params: TfheParams, kernel: str, sm_count: int,
              K: int | None = None) -> TilePlan:
    """The split of a step's contraction at batch B on a card of `sm_count`
    SMs.  Rows are always tiled by 128: at every batch a step's weight tiles
    cross from L2 into shared memory once per row tile, so a smaller row
    tile only adds traffic.  The kernels that hand items out round-robin
    fill the card at the protocol's small batches by split-K
    (`round_robin_split`).  The kernels of `BY_STAGE` spread the last
    partial wave of items over the grid by stage, so a step lasts
    ceil(items x stages / SMs) stages on its slowest block; they take no
    split, and their plan, the mirror of that walk, has split 1 (a split
    would only add pieces, each drained and added into acc on its own;
    PERF.md §6 has the split against the step time on the H100)."""
    p = params
    tiles = -(-B // BM_ROWS) * (p.k + 1) * (p.N // BN_COLS)
    blocks = contraction_blocks(p, kernel, K)
    depth = (p.k + 1) * p.l * p.N // blocks // BK_BYTES    # G*N contraction bytes
    split = 1 if kernel in BY_STAGE else round_robin_split(tiles, blocks, sm_count)
    return TilePlan(split, blocks, tiles, depth)


_sm_counts: "dict[int, int]" = {}


def _sm_count(device: torch.device) -> int:
    sms = _sm_counts.get(device.index)
    if sms is None:
        sms = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


# --- the narrow step of kernels 1 and 2 ------------------------------------

# T: kernels 1 and 2 take the narrow step (``csrc/narrow_rotation.cuh``: the
# Toeplitz weights built in registers as the MMA's A operand, the batch rows
# its N operand, no ring) at this many rows or fewer: the largest of 8, 16,
# 32 and 64 at which it was faster than the ring at every row count measured
# up to it (PERF.md §6; at 64 rows kernel 1 tied).  Above it they take the
# ring (``gen_rotation.cuh``).
NARROW_MAX_ROWS = 32
NARROW_WARPS = 12                  # NARROW_WARPS: the runners, every warp
NARROW_WIN_TAIL = 80               # WIN_TAIL
NARROW_SUM_STRIDE = BN_COLS + 4    # SUM_STRIDE


@dataclasses.dataclass(frozen=True)
class NarrowPlan:
    """How the narrow step cuts a CMUX step's GEMM at `rows` rows on a grid
    of `grid` blocks, the mirror of ``narrow_rotation.cuh``.  A span is
    (output tile of BN_COLS coefficients of polynomial o, digit polynomial
    g, BK_BYTES contraction bytes kt); a step's spans, ordered (tile, g,
    kt), are cut into `grid` contiguous ranges, the first (spans mod grid)
    one longer.  A block takes every limb of its spans: its items, (span,
    limb m), are listed by (tile, m, span) and cut into contiguous ranges,
    one for each of its NARROW_WARPS warps.  The cut is the same at every
    row count."""

    N: int
    k: int
    l: int
    limbs: tuple        # limbs of each output polynomial (TfheParams.limb_plan)
    rows: int
    grid: int

    @classmethod
    def of(cls, B: int, params: TfheParams, grid: int) -> "NarrowPlan":
        p = params
        return cls(p.N, p.k, p.l, tuple(p.limb_plan), B, grid)

    @property
    def per_tile(self) -> int:
        """Spans of one output tile: G digit polynomials of N/128 spans."""
        return (self.k + 1) * self.l * self.N // BK_BYTES

    @property
    def spans(self) -> int:
        return (self.k + 1) * self.N // BN_COLS * self.per_tile

    def spans_of(self, block: int) -> range:
        q, rem = divmod(self.spans, self.grid)
        lo = block * q + min(block, rem)
        return range(lo, lo + q + (block < rem))

    def items(self, block: int) -> "list[tuple[int, int, int, int, int]]":
        """(o, first coefficient, m, g, kt) of each item of `block`, in the
        order of its list."""
        r, P, KT, TJ = self.spans_of(block), self.per_tile, self.N // BK_BYTES, self.N // BN_COLS
        out = []
        for tile in range(r.start // P, -(-r.stop // P)):
            o = tile // TJ
            spans = range(max(tile * P, r.start), min((tile + 1) * P, r.stop))
            out += [(o, tile % TJ * BN_COLS, m, s % P // KT, s % KT)
                    for m in range(self.limbs[o]) for s in spans]
        return out

    def warp_items(self, block: int, warp: int) -> list:
        """The items that warp `warp` of `block` runs."""
        items = self.items(block)
        n = len(items)
        return items[n * warp // NARROW_WARPS:n * (warp + 1) // NARROW_WARPS]


def narrow_step(B: int) -> bool:
    """Whether kernels 1 and 2 take the narrow step at B rows."""
    return 0 < B <= NARROW_MAX_ROWS


# --- the phases of a step: the recording instance of kernels 1 and 2 -------

# The record layout of ``csrc/gen_rotation.cuh`` (REC_*): a header, then for
# each recorded step, block and role (consumer warpgroups 0 and 1, the
# producer) one record of REC_WORDS words; ``step_phases`` names the words.
REC_HEADER = 16
REC_TICKS = 12
REC_TIMER_READS = 64
REC_ROLES = 3
REC_WORDS = 23


@dataclasses.dataclass
class PhaseRecords:
    """One launch of kernel 1 or 2 under `record_phases`: the launch's
    kernel, rows B and CMUX steps, and its record buffer (int64 on the card,
    the layout of ``csrc/gen_rotation.cuh``), which holds steps
    [first, first + count) of the launch."""

    kernel: str
    B: int
    n_steps: int
    first: int
    count: int
    buffer: torch.Tensor


class PhaseRecorder:
    """The launches that `record_phases` records: steps `steps` of each
    launch of kernels 1 and 2 (clipped to the launch's steps), of the
    launches numbered `calls` among those made inside it (all by default).
    `launches` holds a `PhaseRecords` for each launch recorded."""

    def __init__(self, steps: range, calls: "range | None" = None):
        if steps.step != 1:
            raise ValueError(f"record_phases: steps must be a contiguous range, got {steps}")
        self.steps, self.calls = steps, calls
        self.seen = 0
        self.launches: "list[PhaseRecords]" = []

    def pass_over(self) -> int:
        """Number the next launch of kernels 1 and 2; returns its number.  A
        narrow launch is numbered and records nothing."""
        self.seen += 1
        return self.seen - 1

    def window(self, kernel: str, B: int, n_steps: int, device: torch.device) -> tuple:
        """The record arguments of this launch's ``_phases`` entry (buffer,
        blocks it has room for, first step, count), or () if it records
        nothing."""
        call = self.pass_over()
        first, stop = max(self.steps.start, 0), min(self.steps.stop, n_steps)
        if stop <= first or (self.calls is not None and call not in self.calls):
            return ()
        blocks = _sm_count(device)      # one block an SM (__launch_bounds__(THREADS, 1))
        buffer = torch.empty(REC_HEADER + (stop - first) * blocks * REC_ROLES * REC_WORDS,
                             dtype=torch.int64, device=device)
        self.launches.append(PhaseRecords(kernel, B, n_steps, first, stop - first, buffer))
        return buffer.data_ptr(), blocks, first, stop - first


_recorder: "PhaseRecorder | None" = None


@contextlib.contextmanager
def record_phases(steps: range, calls: "range | None" = None):
    """Inside, `cmux_step_gen` and `blind_rotate_gen_full` launch their
    kernel's recording instance (``peba1_<kernel>_phases``) and keep its
    records of `steps` (see `PhaseRecorder`); yields the recorder.  The
    recording instance computes the same acc.  A call that takes the narrow
    step (`narrow_step`) launches the narrow instance and records nothing.
    Outside, and for every other kernel, nothing changes."""
    global _recorder
    outer, _recorder = _recorder, PhaseRecorder(steps, calls)
    try:
        yield _recorder
    finally:
        _recorder = outer


def _check_rotation_shapes(kernel: str, p: TfheParams) -> None:
    if p.N % BK_BYTES:
        raise ValueError(f"{kernel} kernel needs N % {BK_BYTES} == 0, got N={p.N}")


def _launch_rotation(kernel: str, acc: torch.Tensor, amt: torch.Tensor, key: torch.Tensor,
                     p: TfheParams, steps: int, *tail) -> None:
    """Launch ``peba1_<kernel>``, a kernel on the whole-rotation skeleton, on
    acc's device: acc (B, (k+1)*N), amt, the key, a (B, G*N) digits scratch
    and a zeroed grid barrier, then B, `steps`, the step sizes
    (`_step_args`) and the kernel's own `tail` arguments.  Kernels 1 and 2
    launch ``peba1_<kernel>_narrow`` where `narrow_step` says so (counted in
    `narrow_calls` too); otherwise, inside `record_phases`, through
    ``peba1_<kernel>_phases`` with the recorder's arguments after `tail`."""
    B, device = acc.shape[0], acc.device
    digits = torch.empty((B, (p.k + 1) * p.l * p.N), dtype=torch.int8, device=device)
    grid_bar = torch.zeros(1, dtype=torch.int32, device=device)
    entry, rec = "peba1_" + kernel, ()
    narrow = kernel in BY_STAGE and narrow_step(B)
    if narrow:
        entry += "_narrow"
        if _recorder is not None:
            _recorder.pass_over()
    elif _recorder is not None and kernel in BY_STAGE:
        rec = _recorder.window(kernel, B, steps, device)
        entry += "_phases" if rec else ""
    _launch(entry, device, acc.data_ptr(), amt.data_ptr(), key.data_ptr(),
            digits.data_ptr(), grid_bar.data_ptr(), B, steps, *_step_args(p), *tail, *rec)
    launches[kernel] += 1
    if narrow:
        narrow_calls[kernel] += 1


# --- cmux_step_gen ---------------------------------------------------------

@spanned("kernel.cmux_step_gen")
def cmux_step_gen(acc_flat: torch.Tensor, amt: torch.Tensor, vv: torch.Tensor,
                  params: TfheParams) -> torch.Tensor:
    """S whole CMUX steps, updating the accumulator IN PLACE (returned).

    acc_flat: (B, (k+1)*N) int32; amt: (S, B) int32 rotations, taken mod 2N;
    vv: (S, G, C, 2N) int8, S steps of CloudKey.bk_tp.  Step s rotates,
    decomposes and multiplies by vv[s], then adds into acc, exactly as
    ``peba1_tpu.ops.pallas_kernels.cmux_step_gen`` does.  One kernel launch
    for all S steps.
    """
    p = params
    k1, G, C = _sizes(p)
    B, S = acc_flat.shape[0], amt.shape[0]
    device = _check("cmux_step_gen", p, acc_flat=(acc_flat, torch.int32, (B, k1 * p.N)),
                    amt=(amt, torch.int32, (S, B)),
                    vv=(vv, torch.int8, (S, G, C, 2 * p.N)))
    if device.type == "cpu":
        return cmux_step_gen_plain(acc_flat, amt, vv, p)
    _check_rotation_shapes("cmux_step_gen", p)
    if B == 0 or S == 0:
        return acc_flat
    _launch_rotation("cmux_step_gen", acc_flat, amt, vv, p, S)
    return acc_flat


def cmux_step_gen_plain(acc_flat: torch.Tensor, amt: torch.Tensor,
                        vv: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """The plain PyTorch twin of `cmux_step_gen`, same signature and effect:
    `rotate_decompose_plain`, `poly.extprod_toeplitz_i8`, then add, per step."""
    p = params
    B = acc_flat.shape[0]
    acc = acc_flat.view(B, p.k + 1, p.N)
    for s in range(amt.shape[0]):
        d = rotate_decompose_plain(acc_flat, amt[s], p).view(B, -1, p.N)
        acc += poly.extprod_toeplitz_i8(d, vv[s], p.limb_plan)
    return acc_flat


# --- blind_rotate_gen_full -------------------------------------------------

@spanned("kernel.blind_rotate_gen_full")
def blind_rotate_gen_full(amt: torch.Tensor, vv: torch.Tensor, mu: int,
                          params: TfheParams) -> torch.Tensor:
    """The whole blind rotation; returns a new (B, (k+1)*N) int32 accumulator.

    amt: (S+1, B) int32, row 0 the initial body rotation (2N - b_bar) mod 2N,
    row s+1 the rotation of step s (the transpose of
    ``pallas_kernels.blind_rotate_gen_full``'s (B, n+1)); vv: (S, G, C, 2N)
    int8, CloudKey.bk_tp or its first S steps; mu: the torus32 amplitude of
    the all-mu test vector.  acc = [0 | X^amt[0] * mu], then S steps of
    `cmux_step_gen`, in ONE kernel launch.
    """
    p = params
    k1, G, C = _sizes(p)
    S1, B = amt.shape
    device = _check("blind_rotate_gen_full", p, amt=(amt, torch.int32, (max(S1, 1), B)),
                    vv=(vv, torch.int8, (S1 - 1, G, C, 2 * p.N)))
    if device.type == "cpu":
        return blind_rotate_gen_full_plain(amt, vv, mu, p)
    _check_rotation_shapes("blind_rotate_gen_full", p)
    acc = torch.empty((B, k1 * p.N), dtype=torch.int32, device=device)
    if B == 0:
        return acc
    _launch_rotation("blind_rotate_gen_full", acc, amt, vv, p, S1 - 1, mu & 0xFFFFFFFF)
    return acc


def blind_rotate_gen_full_plain(amt: torch.Tensor, vv: torch.Tensor, mu: int,
                                params: TfheParams) -> torch.Tensor:
    """The plain twin of `blind_rotate_gen_full`: the initial accumulator,
    then `cmux_step_gen_plain` over the S steps."""
    acc = rotate.initial_accumulator(amt[0], mu, params)
    return cmux_step_gen_plain(acc.view(amt.shape[1], -1), amt[1:], vv, params)


# --- rotate_decompose ------------------------------------------------------

ROTDEC_STAGES = 4             # acc rows in flight in a block (the ring)
ROTDEC_BLOCKS_PER_SM = 4      # the kernel's __launch_bounds__ minimum (256 threads)
SM_SHARED_BYTES = 233_472     # shared memory of an sm_90 SM (228 KB)
BLOCK_SHARED_MAX = 232_448    # dynamic shared memory a block may opt into
BLOCK_RESERVED = 1_024        # shared memory the runtime keeps for each block


@dataclasses.dataclass(frozen=True)
class RotdecPlan:
    """How `rotate_decompose` runs `rows` rows: `blocks` persistent blocks,
    block x taking rows x, x + blocks, ...; each block a ring of `stages` acc
    rows of `row_bytes` (one bulk load each) and two digit rows of
    `digit_bytes` (one bulk store each), in `smem` bytes of dynamic shared
    memory (``csrc/rotate_decompose.cu`` carves them in that order, then
    the stages' amt words and mbarriers).  `args` are the C entry's
    arguments after the three pointers."""

    rows: int
    blocks: int
    stages: int
    row_bytes: int
    digit_bytes: int
    smem: int
    args: tuple

    def rows_of(self, block: int) -> range:
        return range(block, self.rows, self.blocks)


@functools.lru_cache(maxsize=256)
def rotdec_plan(B: int, params: TfheParams, sm_count: int) -> RotdecPlan:
    """`rotate_decompose`'s grid at batch B on a card of `sm_count` SMs: as
    many blocks as fit on an SM at once by shared memory, at most
    `ROTDEC_BLOCKS_PER_SM`, on every SM, but never more blocks than rows.
    The rule reads only the kernel's fixed shared-memory use (no occupancy
    query on the host); cached, since the scan of steps asks it once a
    CMUX step.  Raises for shapes the kernel does not take."""
    p = params
    if p.N % 64:          # whole 16-byte rows at every k and l (N is a power of two)
        raise ValueError(f"rotate_decompose kernel needs N % 64 == 0, got N={p.N}")
    S = ROTDEC_STAGES
    row, drow = 4 * (p.k + 1) * p.N, (p.k + 1) * p.l * p.N
    smem = S * row + 2 * drow + 16 * -(-S // 4) + 8 * S
    if smem > BLOCK_SHARED_MAX:
        raise ValueError(f"rotate_decompose kernel: {smem} bytes of shared memory a block "
                         f"at N={p.N}, k={p.k}, l={p.l}; at most {BLOCK_SHARED_MAX}")
    per_sm = min(ROTDEC_BLOCKS_PER_SM, SM_SHARED_BYTES // (smem + BLOCK_RESERVED))
    blocks = min(B, per_sm * sm_count)
    args = (B, p.N.bit_length() - 1, p.k, p.l, p.bgbit, dec.gadget_offset(p), blocks, S, smem)
    return RotdecPlan(B, blocks, S, row, drow, smem, args)


@spanned("kernel.rotate_decompose")
def rotate_decompose(acc_flat: torch.Tensor, amt: torch.Tensor,
                     params: TfheParams) -> torch.Tensor:
    """Fused rotate + difference + gadget decomposition.

    acc_flat: (B, (k+1)*N) int32, 16-byte aligned on the card; amt: (B,)
    int32 in [0, 2N).  Returns the digits (B, (k+1)*l*N) int8, digit q of
    coefficient t of polynomial u at column (u*l+q)*N + t, as
    ``pallas_kernels.rotate_decompose`` does.  The scan of steps calls it
    once a CMUX step, so its host path is short: the checks below, then the
    cached plan.
    """
    p = params
    B, cols = acc_flat.shape[0], (p.k + 1) * p.N
    device = acc_flat.device
    if (acc_flat.dtype != torch.int32 or amt.dtype != torch.int32
            or acc_flat.shape != (B, cols) or amt.shape != (B,) or amt.device != device
            or not acc_flat.is_contiguous() or not amt.is_contiguous()):
        _check("rotate_decompose", p, acc_flat=(acc_flat, torch.int32, (B, cols)),
               amt=(amt, torch.int32, (B,)))        # raises, naming what is wrong
    if device.type == "cpu":
        return rotate_decompose_plain(acc_flat, amt, p)
    if device.type != "cuda":
        raise ValueError(f"rotate_decompose: no kernel for {device}")
    plan = rotdec_plan(B, p, _sm_count(device))
    digits = torch.empty((B, plan.digit_bytes), dtype=torch.int8, device=device)
    if B == 0:
        return digits
    acc_ptr, digits_ptr = acc_flat.data_ptr(), digits.data_ptr()
    if (acc_ptr | digits_ptr) & 15:
        raise ValueError("rotate_decompose kernel: acc_flat and the digits must be 16-byte "
                         f"aligned for the bulk copies, got addresses {acc_ptr:#x}, "
                         f"{digits_ptr:#x}")
    _launch("peba1_rotate_decompose", device, acc_ptr, amt.data_ptr(), digits_ptr, *plan.args)
    launches["rotate_decompose"] += 1
    return digits


def rotate_decompose_plain(acc_flat: torch.Tensor, amt: torch.Tensor,
                           params: TfheParams) -> torch.Tensor:
    """The plain twin of `rotate_decompose`: gather rotate, decompose."""
    p = params
    B = acc_flat.shape[0]
    acc = acc_flat.view(B, p.k + 1, p.N)
    d = dec.decompose(rotate.negacyclic_rotate(acc, amt[:, None]) - acc, p)
    return d.movedim(-1, -2).reshape(B, -1)                  # (B, (u, q, t))


# --- extprod_recombine -----------------------------------------------------

@spanned("kernel.extprod_recombine")
def extprod_recombine(digits: torch.Tensor, w: torch.Tensor,
                      params: TfheParams) -> torch.Tensor:
    """External product with the limb recombination as the GEMM's epilogue.

    digits: (B, G*N) int8 (`rotate_decompose`'s layout); w: (C*N, G*N) int8,
    one step of CloudKey.bk_w (the port's transposed layout, see
    ``keys.CloudKey``).  Returns (B, (k+1)*N) int32, equal to
    ``pallas_kernels.extprod_recombine`` on JAX's (G*N, C*N) form of w.
    """
    p = params
    k1, G, C = _sizes(p)
    B = digits.shape[0]
    device = _check("extprod_recombine", p, digits=(digits, torch.int8, (B, G * p.N)),
                    w=(w, torch.int8, (C * p.N, G * p.N)))
    if device.type == "cpu":
        return extprod_recombine_plain(digits, w, p)
    _check_rotation_shapes("extprod_recombine", p)
    if B == 0:
        return torch.empty((B, k1 * p.N), dtype=torch.int32, device=device)
    plan = tile_plan(B, p, "extprod_recombine", _sm_count(device))
    # One split stores its tiles; several add theirs into zeros.
    alloc = torch.zeros if plan.split > 1 else torch.empty
    out = alloc((B, k1 * p.N), dtype=torch.int32, device=device)
    _launch("peba1_extprod_recombine", device, out.data_ptr(), digits.data_ptr(),
            w.data_ptr(), B, p.N, p.k, p.l, p.bk_limbs, p.bk_body_limbs, plan.split)
    launches["extprod_recombine"] += 1
    return out


def extprod_recombine_plain(digits: torch.Tensor, w: torch.Tensor,
                            params: TfheParams) -> torch.Tensor:
    """The plain twin of `extprod_recombine`: a float64 GEMM (exact, see
    ``poly``), then `poly.recombine_plan_i32`."""
    p = params
    B = digits.shape[0]
    cols = poly.exact_matmul(digits, w.T).view(B, -1, p.N)   # (B, C, N)
    return poly.recombine_plan_i32(cols, p.limb_plan).reshape(B, -1)


# --- cmux_step -------------------------------------------------------------

@spanned("kernel.cmux_step")
def cmux_step(acc_flat: torch.Tensor, amt: torch.Tensor, w: torch.Tensor,
              params: TfheParams) -> torch.Tensor:
    """S whole CMUX steps against precomputed weights, updating the
    accumulator IN PLACE (returned).

    acc_flat: (B, (k+1)*N) int32; amt: (S, B) int32; w: (S, C*N, G*N) int8,
    S steps of CloudKey.bk_w (or one step built by `poly.toeplitz_weights`).
    Step s is `rotate_decompose`, `extprod_recombine` and an add, as
    ``pallas_kernels.cmux_step`` does; all digits of a step exist before any
    acc write.  One kernel launch for all S steps.
    """
    p = params
    k1, G, C = _sizes(p)
    B, S = acc_flat.shape[0], amt.shape[0]
    device = _check("cmux_step", p, acc_flat=(acc_flat, torch.int32, (B, k1 * p.N)),
                    amt=(amt, torch.int32, (S, B)),
                    w=(w, torch.int8, (S, C * p.N, G * p.N)))
    if device.type == "cpu":
        return cmux_step_plain(acc_flat, amt, w, p)
    _check_rotation_shapes("cmux_step", p)
    if B == 0 or S == 0:
        return acc_flat
    split = tile_plan(B, p, "cmux_step", _sm_count(device)).split
    _launch_rotation("cmux_step", acc_flat, amt, w, p, S, split)
    return acc_flat


def cmux_step_plain(acc_flat: torch.Tensor, amt: torch.Tensor, w: torch.Tensor,
                    params: TfheParams) -> torch.Tensor:
    """The plain twin of `cmux_step`, same signature and effect."""
    for s in range(amt.shape[0]):
        d = rotate_decompose_plain(acc_flat, amt[s], params)
        acc_flat += extprod_recombine_plain(d, w[s], params)
    return acc_flat


# --- fused_blind_rotate ----------------------------------------------------

@spanned("kernel.fused_blind_rotate")
def fused_blind_rotate(amt: torch.Tensor, amat: torch.Tensor, mu: int,
                       params: TfheParams) -> torch.Tensor:
    """The whole blind rotation against the A-matrix; returns a new
    (B, (k+1)*N) int32 accumulator.

    amt: (S+1, B) int32, row 0 the initial body rotation (2N - b_bar) mod 2N,
    row s+1 the rotation of step s (the transpose of
    ``pallas_kernels.fused_blind_rotate``'s (B, n+1)); amat: (S, C, G, span,
    K) int8, CloudKey.bk_amat (the port's layout, ``poly.prepare_amat``) or
    its first S steps; mu: the torus32 amplitude of the all-mu test vector.
    K is read from amat's shape, as the JAX wrapper does; span must be
    N + (N/K - 1)*K.  One kernel launch.
    """
    p = params
    k1, G, C = _sizes(p)
    S1, B = amt.shape
    K = amat.shape[-1] if amat.dim() == 5 else 0
    if K <= 0 or p.N % K:
        raise ValueError(f"fused_blind_rotate: amat's block K={K} must divide N={p.N}")
    _, _, span = poly.amat_geometry(p.N, K)
    device = _check("fused_blind_rotate", p, amt=(amt, torch.int32, (max(S1, 1), B)),
                    amat=(amat, torch.int8, (S1 - 1, C, G, span, K)))
    if device.type == "cpu":
        return fused_blind_rotate_plain(amt, amat, mu, p)
    _check_rotation_shapes("fused_blind_rotate", p)
    if K % BK_BYTES:
        raise ValueError(f"fused_blind_rotate kernel needs K % {BK_BYTES} == 0, got K={K}")
    acc = torch.empty((B, k1 * p.N), dtype=torch.int32, device=device)
    if B == 0:
        return acc
    split = tile_plan(B, p, "fused_blind_rotate", _sm_count(device), K).split
    _launch_rotation("fused_blind_rotate", acc, amt, amat, p, S1 - 1, K, split,
                     mu & 0xFFFFFFFF)
    return acc


def fused_blind_rotate_plain(amt: torch.Tensor, amat: torch.Tensor, mu: int,
                             params: TfheParams) -> torch.Tensor:
    """The plain twin of `fused_blind_rotate`: the initial accumulator, then
    per step `rotate_decompose_plain`, `poly.extprod_amat_i8` and an add."""
    p = params
    B = amt.shape[1]
    acc_flat = rotate.initial_accumulator(amt[0], mu, p).view(B, -1)
    acc = acc_flat.view(B, p.k + 1, p.N)
    for s in range(amt.shape[0] - 1):
        d = rotate_decompose_plain(acc_flat, amt[s + 1], p).view(B, -1, p.N)
        acc += poly.extprod_amat_i8(d, amat[s], p.limb_plan, p.N)
    return acc_flat
