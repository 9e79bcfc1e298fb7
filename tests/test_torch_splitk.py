"""The split-K plan of the kernels on the whole-rotation skeleton, and its
arithmetic.

`cuda_kernels.tile_plan` picks how many splits of a CMUX step's contraction
`cmux_step_gen`, `blind_rotate_gen_full`, `cmux_step`, `extprod_recombine`
and `fused_blind_rotate` run; each split adds its recombined delta into the
accumulator (or `extprod_recombine`'s zeroed output) with an atomic add on
the card.  `cmux_step_gen` and `blind_rotate_gen_full` walk a step's work
items by stage (`TilePlan.pieces`, the mirror of ``whole_rotation.cuh``'s
``piece_at``).  Here, on the CPU: the plan for every configuration that
runs one of them covers each contraction block exactly once and follows its
rule; the walk by stage covers every stage of every item once and lasts
ceil(items x stages / grid) stages; and the per-split and per-piece deltas,
summed mod 2^32, are the unsplit external product bit for bit; one step
built from them equals the Pallas kernels in interpret mode.  Each of these kernels is one launch a bootstrap call
(`cmux_step` under w_streaming one a CMUX step), as
`chip_smoke.expected_launches` counts it.  The CUDA kernels themselves are
tested on the card by tests/test_torch_cuda.py and `python3 chip_smoke.py`.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cell_params, expected_launches, fused_params
from peba1_tpu.ops import pallas_kernels as pk
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.params import TOY, TOY_FAST, TOY_T2
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.ops import poly, rotate
from peba1_tpu_torch.ops.bootstrap import selected_kernel
from peba1_tpu_torch.params import PRESETS
from peba1_tpu_torch.torus import wrap_i32

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores.
torch.set_num_threads(1)

ROTATION_KERNELS = ("cmux_step_gen", "blind_rotate_gen_full", "fused_blind_rotate", "cmux_step")
CONFIGS = {**{name: p for name, p in PRESETS.items() if selected_kernel(p) in ROTATION_KERNELS},
           **fused_params()}
BATCHES = (1, 67, 184, 760, 1000, 8192)
SM_COUNTS = (132, 114)


def test_every_rotation_configuration_is_planned():
    assert {selected_kernel(p) for p in CONFIGS.values()} == set(ROTATION_KERNELS)
    assert len(CONFIGS) == 14


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tile_plan_covers_each_block_once_and_follows_its_rule(name, B, sms):
    p = CONFIGS[name]
    kernel = selected_kernel(p)
    plan = ck.tile_plan(B, p, kernel, sms)
    G = (p.k + 1) * p.l
    K, U, _ = poly.amat_geometry(p.N, p.amat_block)
    assert plan.tiles == -(-B // ck.BM_ROWS) * (p.k + 1) * (p.N // ck.BN_COLS)
    assert plan.blocks == (G * U if kernel == "fused_blind_rotate" else G)
    assert plan.blocks % plan.split == 0
    # Each (g, u) block (each g for the generator) in exactly one split.
    covered = [b for sp in range(plan.split) for b in plan.blocks_of(sp)]
    assert sorted(covered) == list(range(plan.blocks))
    if kernel == "fused_blind_rotate":
        assert sorted(divmod(b, U) for b in covered) == [(g, u) for g in range(G)
                                                         for u in range(U)]
    # The rule: kernels walked by stage are unsplit; the others take the
    # least divisor giving two items per SM, else every block.
    enough = [d for d in range(1, plan.blocks + 1)
              if plan.blocks % d == 0 and plan.tiles * d >= 2 * sms]
    round_robin = enough[0] if enough else plan.blocks
    assert ck.round_robin_split(plan.tiles, plan.blocks, sms) == round_robin
    assert plan.split == (1 if kernel in ck.BY_STAGE else round_robin)


def test_tile_plan_splits_the_protocol_batches():
    """The authentication's 184 rows and the sweep's 760 are split on the
    round-robin kernel; 8,192 rows fill the card unsplit.  The kernels
    walked by stage are unsplit at every batch, though round-robin would
    split them as it splits kernel 6."""
    fast = fused_params()["peba1_128_fast_fused"]
    genf = PRESETS["peba1_128_fast_genf"]
    t2_gen = PRESETS["peba1_128_t2_gen"]
    assert [ck.tile_plan(B, fast, "fused_blind_rotate", 132).split
            for B in (184, 760, 8192)] == [8, 2, 1]
    assert [ck.tile_plan(B, genf, "blind_rotate_gen_full", 132).split
            for B in (184, 760, 8192)] == [1, 1, 1]
    assert [ck.round_robin_split(ck.tile_plan(B, genf, "blind_rotate_gen_full", 132).tiles,
                                 4, 132) for B in (184, 760, 8192)] == [4, 2, 1]
    # k=2: G = 6 digit polynomials; 184 rows are 2 x 3 x 8 = 48 tiles.
    assert [ck.tile_plan(B, t2_gen, "cmux_step_gen", 132).split
            for B in (184, 760, 8192)] == [1, 1, 1]
    assert [ck.round_robin_split(ck.tile_plan(B, t2_gen, "cmux_step_gen", 132).tiles,
                                 6, 132) for B in (184, 760, 8192)] == [6, 2, 1]


def test_tile_plan_splits_the_w_kernels():
    """cmux_step at t2 splits as cmux_step_gen does (the same product); at
    fast (G = 4) 184 rows are 2 x 2 x 16 = 64 tiles.  extprod_recombine at
    t2 splits 1,000 rows (8 x 3 x 8 = 192 tiles, under two per SM) in two."""
    t2, fast = PRESETS["peba1_128_t2"], PRESETS["peba1_128_fast_stream"]
    assert [ck.tile_plan(B, t2, "cmux_step", 132).split
            for B in (184, 760, 8192)] == [6, 2, 1]
    assert [ck.tile_plan(B, fast, "cmux_step", 132).split for B in (184, 1000)] == [4, 2]
    assert [ck.tile_plan(B, t2, "extprod_recombine", 132).split
            for B in (1000, 2048)] == [2, 1]


# --- the walk by stage of kernels 1 and 2 -----------------------------------

TFHE128 = cell_params()["peba1_tfhe128_genf"]
WALK_CONFIGS = {**CONFIGS, **cell_params()}
WALK_BATCHES = (1, 92, 128, 256, 512, 1152, 8192)
GRIDS = (132, 114, 78)
# Rows of each bootstrap call of one authentication (function_f then
# function_g, 128 slots of 8 bits, bound 256) -> calls of that size: 2,351
# calls, 216,176 bootstraps.
AUTH_CALL_ROWS = {1: 425, 2: 472, 4: 471, 8: 85, 9: 3, 16: 69, 24: 1, 32: 69, 48: 1, 64: 69,
                  128: 248, 256: 225, 512: 202, 1024: 8, 1152: 3}


def test_the_cell_lattice_is_the_benchmark_configuration():
    """chip_smoke's peba1_tfhe128_genf is what the harness builds from
    perfbench/configs/peba1_tfhe128.json."""
    from perfbench import port
    config = Path(__file__).resolve().parent.parent / "perfbench/configs/peba1_tfhe128.json"
    assert port.params(json.loads(config.read_text())) == TFHE128


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("B", WALK_BATCHES)
@pytest.mark.parametrize("name", sorted(WALK_CONFIGS))
def test_the_walk_by_stage_covers_each_stage_once(name, B, grid):
    """The pieces of all `grid` blocks cover every (item, stage) of a step
    exactly once; the slowest block runs floor(U/W)*P + ceil((U mod W)*P/W)
    stages, no more than round-robin; and a step whose items fill whole
    waves is walked round-robin."""
    p = WALK_CONFIGS[name]
    plan = ck.tile_plan(B, p, selected_kernel(p), grid)
    U, P = plan.items, plan.stages
    assert P == plan.blocks // plan.split * plan.depth and P > 0
    seen = np.zeros(U * P, dtype=np.int64)
    longest = 0
    for b in range(grid):
        pieces = plan.pieces(b, grid)
        assert len(pieces) <= U // grid + 2
        for item, first, end in pieces:
            assert 0 <= item < U and 0 <= first < end <= P
            seen[item * P + first:item * P + end] += 1
        longest = max(longest, sum(end - first for _, first, end in pieces))
        if U % grid == 0:
            assert pieces == [(i, 0, P) for i in range(b, U, grid)]
    assert (seen == 1).all()
    assert longest == plan.critical_stages(grid) == U // grid * P + -(-(U % grid) * P // grid)
    assert longest <= plan.round_robin_stages(grid) == -(-U // grid) * P


@pytest.mark.parametrize("grid", [1, 2, 3, 12, 132])
def test_a_whole_last_wave_is_walked_round_robin(grid):
    """U a multiple of the grid: no tail, every block its round-robin items
    whole, and the slowest block as long as under round-robin."""
    plan = ck.TilePlan(1, 6, 132, 8)                          # 132 items of 48 stages
    assert plan.items % grid == 0
    for b in range(grid):
        assert plan.tail_range(b, grid) == range(0, 0)
        assert plan.pieces(b, grid) == [(i, 0, 48) for i in range(b, 132, grid)]
    assert plan.critical_stages(grid) == plan.round_robin_stages(grid) == 132 // grid * 48


H100_SMEM_PER_BLOCK = 232_448    # shared memory a block may opt in to on the H100 (227 KiB)
EARLY_CONFIGS = {name: p for name, p in WALK_CONFIGS.items()
                 if selected_kernel(p) in ck.BY_STAGE} | {"toy": PRESETS["toy"]}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("B", WALK_BATCHES)
@pytest.mark.parametrize("name", sorted(EARLY_CONFIGS))
def test_the_stages_expanded_inside_barrier_1(name, B, grid):
    """Kernels 1 and 2's producer expands the weight tiles of its first unit's
    first stages inside barrier 1 (``gen_rotation.cuh``'s ``expand_early``):
    on a ring of 4 stages at every ring degree the presets use, as many as
    the ring's depth less one (one below a full row tile), never more than
    its first unit (the stages of its first piece in the digit polynomial of
    that piece's first stage), at least one on a walk that is not empty,
    none on an empty walk."""
    p = EARLY_CONFIGS[name]
    plan = ck.tile_plan(B, p, "blind_rotate_gen_full", grid)
    ring = ck.gen_ring_stages(p.N, H100_SMEM_PER_BLOCK)
    assert ring == ck.RING_MAX_STAGES
    most = 1 if B < ck.BM_ROWS else ring - 1
    for b in range(grid):
        pieces = plan.pieces(b, grid)
        early = plan.early_stages(b, grid, ring, B)
        if not pieces:
            assert early == 0
            continue
        _, first, end = pieces[0]
        unit = sum(1 for s in range(first, end) if s // plan.depth == first // plan.depth)
        assert 1 <= early <= most <= ring - 1 and early <= unit
        assert early == min(most, unit)


def test_the_card_cases_of_the_early_stages():
    """The shapes at which tests/test_torch_cuda.py's walk test checks the
    early stages on the H100's 132 SMs: one row at TOY (N = 128, a unit is
    one stage), where most blocks' walk is empty and every other block
    expands one stage; 128 rows at the cells' lattice, where some blocks'
    first unit is shorter than the ring's depth less one; 8,192 rows at TOY,
    where every first unit is; 8,192 rows at the cells' lattice, where every
    block expands three.  The ring keeps its four stages beside the windows
    and the table of units at every ring degree up to 2,048, and loses one
    a byte short of them."""
    toy = ck.tile_plan(1, PRESETS["toy"], "blind_rotate_gen_full", 132)
    early = [toy.early_stages(b, 132, 4, 1) for b in range(132)]
    assert early.count(0) > 66 and set(early) == {0, 1}
    cell = ck.tile_plan(128, TFHE128, "blind_rotate_gen_full", 132)
    early = [cell.early_stages(b, 132, 4, 128) for b in range(132)]
    assert min(early) >= 1 and {1, 2, 3} <= set(early)
    toy = ck.tile_plan(8192, PRESETS["toy"], "blind_rotate_gen_full", 132)
    assert {toy.early_stages(b, 132, 4, 8192) for b in range(132)} == {1}
    wide = ck.tile_plan(8192, TFHE128, "blind_rotate_gen_full", 132)
    assert {wide.early_stages(b, 132, 4, 8192) for b in range(132)} == {3}
    assert [ck.gen_ring_stages(N, H100_SMEM_PER_BLOCK) for N in (512, 1024, 2048)] == [4] * 3
    four = 1024 + 4 * (ck.RING_STAGE_BYTES + 16) + 8 * 1104 + 16 + 128 * 32
    assert ck.gen_ring_stages(1024, four) == 4 and ck.gen_ring_stages(1024, four - 1) == 3


def test_an_authentication_saves_a_sixth_of_its_stages():
    """One authentication's calls at the benchmark's TFHE v1.x lattice on
    132 SMs: every launch ends in a partial wave, and the slowest block's
    stages a step, summed over the calls, fall from 46,904 (round-robin at
    its split) to 38,917; calls of 1 to 128 rows from 16 stages to 12,
    calls of 256 rows not at all."""
    assert sum(AUTH_CALL_ROWS.values()) == 2351
    assert sum(B * n for B, n in AUTH_CALL_ROWS.items()) == 216176
    before = after = 0
    for B, calls in AUTH_CALL_ROWS.items():
        plan = ck.tile_plan(B, TFHE128, "blind_rotate_gen_full", 132)
        round_robin = dataclasses.replace(
            plan, split=ck.round_robin_split(plan.tiles, plan.blocks, 132))
        pair = (round_robin.round_robin_stages(132), plan.critical_stages(132))
        before += calls * pair[0]
        after += calls * pair[1]
        if B <= 128:
            assert pair == (16, 12)
        if B == 256:
            assert pair == (24, 24)
    assert (before, after) == (46904, 38917)


@pytest.mark.parametrize("name", sorted(n for n, p in CONFIGS.items() if not p.w_streaming))
def test_expected_launches_is_one_a_bootstrap_call(name):
    """The smoke's launch count for every configuration on the skeleton that
    holds its whole key: its kernel once per bootstrap call, every other
    kernel never."""
    p = CONFIGS[name]
    want = dict.fromkeys(ck.launches, 0)
    want[selected_kernel(p)] = 7
    assert expected_launches(p, 7) == want


@pytest.mark.parametrize("name,per_call", [("peba1_128_t2", 1), ("toy_t2", 1),
                                           ("peba1_128_t2_stream", 630),
                                           ("peba1_128_fast_stream", 630)])
def test_expected_launches_of_cmux_step(name, per_call):
    """cmux_step on bk_w: one launch for all n steps of a bootstrap call;
    under w_streaming one call, so one launch, a step."""
    p = PRESETS[name]
    assert expected_launches(p, 7) == {**dict.fromkeys(ck.launches, 0), "cmux_step": 7 * per_call}


# --- the arithmetic of the splits, at toy sizes -----------------------------

STEP_CASES = {
    "fused_toy_fast_u1": ("fused_blind_rotate", TOY_FAST),
    "fused_toy_t2_u1": ("fused_blind_rotate", TOY_T2),
    "fused_toy_fast_u2": ("fused_blind_rotate", dataclasses.replace(TOY_FAST, N=256)),
    "genf_toy_fast": ("blind_rotate_gen_full", TOY_FAST),
    "genf_toy_t2": ("blind_rotate_gen_full", TOY_T2),
    "gen_toy_t2": ("cmux_step_gen", dataclasses.replace(TOY_T2, use_gen_step=True)),
    "gen_toy_n256": ("cmux_step_gen", dataclasses.replace(TOY, N=256, use_gen_step=True)),
    "gen_toy_tfhers_bool": ("cmux_step_gen", PRESETS["toy_tfhers_bool"]),
    "w_toy_t2": ("cmux_step", TOY_T2),
    "w_toy_fast": ("cmux_step", dataclasses.replace(TOY_FAST, use_fused_step=True)),
    "ext_toy_t2": ("extprod_recombine", dataclasses.replace(TOY_T2, use_fused_step=False,
                                                            use_pallas_extprod=True)),
    "ext_toy_fast": ("extprod_recombine", dataclasses.replace(TOY_FAST,
                                                              use_pallas_extprod=True)),
}
W_KERNELS = ("cmux_step", "extprod_recombine")      # on one step of bk_w's layout
BATCH = 11
MU = -(1 << 29) + 12345
prepare_amat = jax.jit(jpoly.prepare_amat, static_argnames="block")


def product(kernel, p, d, key):
    """The plain external product of digits (B, G, N) and one step of
    `kernel`'s key, (B, k+1, N) int32."""
    if kernel == "fused_blind_rotate":
        return poly.extprod_amat_i8(d, key, p.limb_plan, p.N)
    if kernel in W_KERNELS:
        B = d.shape[0]
        return ck.extprod_recombine_plain(d.reshape(B, -1), key, p).view(B, p.k + 1, p.N)
    return poly.extprod_toeplitz_i8(d, key, p.limb_plan)


def piece_delta(kernel, p, digits, key, plan, item, first, end):
    """The recombined delta of stages [first, end) of work item `item` alone
    (one row and column tile, so the item is split `item % split`): stage s
    is 128 contraction bytes, stage s % depth of the item's contraction
    block s // depth; the generator kernels read a digit polynomial in
    reversed coefficient order (``gen_rotation.cuh``), the others in natural
    order."""
    G = (p.k + 1) * p.l
    K, U, _ = poly.amat_geometry(p.N, p.amat_block)
    blocks = plan.blocks_of(item % plan.split)
    mask = torch.zeros((G, p.N), dtype=torch.bool)
    for s in range(first, end):
        b, lo = blocks[s // plan.depth], s % plan.depth * ck.BK_BYTES
        if kernel == "fused_blind_rotate":
            g, u = divmod(b, U)
            mask[g, u * K + lo:u * K + lo + ck.BK_BYTES] = True
        elif kernel in ("cmux_step_gen", "blind_rotate_gen_full"):
            mask[b, p.N - lo - ck.BK_BYTES:p.N - lo] = True
        else:
            mask[b, lo:lo + ck.BK_BYTES] = True
    return product(kernel, p, torch.where(mask, digits, torch.zeros_like(digits)), key)


def split_delta(kernel, p, digits, key, plan, sp):
    """The recombined delta of split `sp` alone: the digits outside its
    blocks set to zero, then the plain external product."""
    G = (p.k + 1) * p.l
    K, U, _ = poly.amat_geometry(p.N, p.amat_block)
    mask = torch.zeros((G, p.N), dtype=torch.bool)
    for b in plan.blocks_of(sp):
        if kernel == "fused_blind_rotate":
            g, u = divmod(b, U)
            mask[g, u * K:(u + 1) * K] = True
        else:
            mask[b] = True
    return product(kernel, p, torch.where(mask, digits, torch.zeros_like(digits)), key)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_split_deltas_sum_to_the_unsplit_step(name):
    """For every split the kernel can take (every divisor of its blocks for
    kernels 4-6, 1 for the kernels walked by stage), the per-split deltas
    summed with int32 wraparound equal the unsplit product, and so do the
    deltas of the pieces that the walk by stage gives grids of 3 and 5 blocks
    (cuts inside an item, and inside a digit polynomial where N > 128); acc
    plus that sum equals one step of the Pallas kernel in interpret mode (the
    whole rotation cut to one step, or cmux_step_gen or cmux_step on the same
    starting accumulator), and the sum alone equals extprod_recombine on the
    same digits.  The W kernels' key is one step of bk_w, built by each
    package from the same generator."""
    kernel, p = STEP_CASES[name]
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    rng = np.random.default_rng(21)
    vv = rng.integers(-128, 128, (1, G, C, 2 * p.N)).astype(np.int8)
    vv[0, 0, 0, :] = -128
    amt = rng.integers(0, 2 * p.N, (2, BATCH)).astype(np.int32)
    amt[:, :3] = [0, p.N, 2 * p.N - 1]
    tamt = torch.as_tensor(amt)
    acc = rotate.initial_accumulator(tamt[0], MU, p).view(BATCH, -1)
    if kernel == "fused_blind_rotate":
        jkey = prepare_amat(jnp.asarray(vv), block=p.amat_block)
        key = torch.tensor(np.asarray(jkey)).transpose(-1, -2).contiguous()
        want = pk.fused_blind_rotate(jnp.asarray(amt.T), jkey, jnp.int32(MU), p,
                                     interpret=True)
    elif kernel == "blind_rotate_gen_full":
        key = torch.as_tensor(vv)
        want = pk.blind_rotate_gen_full(jnp.asarray(amt.T), jnp.asarray(vv), jnp.int32(MU), p,
                                        interpret=True)
    elif kernel == "cmux_step_gen":
        key = torch.as_tensor(vv)
        want = pk.cmux_step_gen(jnp.asarray(acc.numpy()), jnp.asarray(amt[1]),
                                jnp.asarray(vv[0]), p, interpret=True)
    else:
        key = poly.prepare_w_full(torch.as_tensor(vv))          # (1, C*N, G*N)
        jw = jpoly.prepare_w_full(jnp.asarray(vv))[0]           # JAX's (G*N, C*N)
    digits = ck.rotate_decompose_plain(acc, tamt[1], p).view(BATCH, G, p.N)
    if kernel == "cmux_step":
        want = pk.cmux_step(jnp.asarray(acc.numpy()), jnp.asarray(amt[1]), jw, p,
                            interpret=True)
    elif kernel == "extprod_recombine":
        want = pk.extprod_recombine(jnp.asarray(digits.reshape(BATCH, -1).numpy()), jw, p,
                                    interpret=True)
    whole = product(kernel, p, digits, key[0])
    blocks = ck.contraction_blocks(p, kernel)
    depth = ck.tile_plan(BATCH, p, kernel, 132).depth
    splits = (1,) if kernel in ck.BY_STAGE else [s for s in range(1, blocks + 1)
                                                 if blocks % s == 0]
    for split in splits:
        plan = ck.TilePlan(split, blocks, 1, depth)
        total = sum(split_delta(kernel, p, digits, key[0], plan, sp).to(torch.int64)
                    for sp in range(split))
        np.testing.assert_array_equal(wrap_i32(total).numpy(), whole.numpy())
        for grid in (3, 5):
            total = sum(piece_delta(kernel, p, digits, key[0], plan, *piece).to(torch.int64)
                        for b in range(grid) for piece in plan.pieces(b, grid))
            np.testing.assert_array_equal(wrap_i32(total).numpy(), whole.numpy())
    if kernel == "extprod_recombine":
        step = whole
    else:
        step = wrap_i32(acc.view(BATCH, p.k + 1, p.N).to(torch.int64) + whole)
    np.testing.assert_array_equal(np.asarray(want), step.reshape(BATCH, -1).numpy())
    if kernel in ("cmux_step_gen", "cmux_step"):                # the wrapper's CPU twin
        got = getattr(ck, kernel)(acc.clone(), tamt[1:], key, p)
    elif kernel == "extprod_recombine":
        got = ck.extprod_recombine(digits.reshape(BATCH, -1), key[0], p)
    else:
        got = getattr(ck, kernel)(tamt, key, MU, p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
