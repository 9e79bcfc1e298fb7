"""The records of a CMUX step's phases (kernels 1 and 2's recording instance)
and their reduction (``peba1_tpu_torch.step_phases``).

On the CPU: the reduction on records built by hand with known phases, the
record layout against ``csrc/gen_rotation.cuh``, and `record_phases`'s
window.  On the card (marker `cuda`; this file imports no jax): the
recording instance's acc bit-equal to the default instance's, and its
records whole.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from peba1_tpu_torch import step_phases as sp
from peba1_tpu_torch.ops import cuda_kernels as ck

GHZ = 2.0           # the SM clock of the hand-built records


def sp_params():
    from peba1_tpu_torch.params import TOY
    return TOY


def build(steps: int, grid: int, first: int = 0) -> "tuple[np.ndarray, list[dict]]":
    """A record buffer with known phases, and the line `reduce_steps` must
    give for each step.  Step i starts at S_i; block b's digit phase ends at
    S + 4,000 + 500 b ns; barrier 1 releases 300 ns after the last arrival
    (+10 b); block b's GEMM phase lasts 20,000 + 1,000 b (block grid-1 the
    critical one), its consumers' fill 1,200 ns and last epilogue 600 ns, 40
    stages; barrier 2 releases 400 ns after the last arrival.  Before
    barrier 1's end, block b's producer waits 400 ns for its windows and
    expands 3 stages in 1,500 ns, ending 50 ns after its digit phase; block
    0's walk is empty (unless it is the only block)."""
    R, Wd = ck.REC_ROLES, ck.REC_WORDS
    buf = np.zeros(ck.REC_HEADER + steps * grid * R * Wd, dtype=np.int64)
    buf[:3] = grid, first, steps
    buf[3:3 + ck.REC_TICKS] = 32
    buf[3 + ck.REC_TICKS] = 40 * ck.REC_TIMER_READS      # 40 ns a stamp
    rec = buf[ck.REC_HEADER:].reshape(steps, grid, R, Wd)
    W = sp.W
    want, S = [], 1_000_000
    for i in range(steps):
        a1 = S + 4_000 + 500 * np.arange(grid)
        L1 = int(a1.max())
        x1 = L1 + 300 + 10 * np.arange(grid)
        gemm = 20_000 + 1_000 * np.arange(grid)
        a2 = x1 + gemm
        L2 = int(a2.max())
        E = L2 + 400
        for b in range(grid):
            for role in range(R):
                r = rec[i, b, role]
                r[W["T_START"]] = S + role
                r[W["T_DIGITS"]] = a1[b] - 5
                r[W["T_BAR1_EXIT"]] = x1[b]
                r[W["T_GEMM_END"]] = a2[b] - 3
                r[W["T_BAR2_EXIT"]] = E - 2 * (grid - 1 - b) * (role == 1)
                r[W["GEMM_CYCLES"]] = GHZ * (a2[b] - 3 - x1[b])
                producer = role == 2
                r[W["FILL"]] = GHZ * (900 if producer else 1_200)
                r[W["WAIT"]] = GHZ * (5_000 if producer else 2_000 + 100 * role)
                r[W["WAIT2"]] = GHZ * (1_000 if producer else 8_000)
                r[W["WORK"]] = GHZ * (9_000 if producer else 700)
                r[W["LAST"]] = GHZ * (500 if producer else 600)
                r[W["ISSUE"]] = GHZ * (300 if producer else 4_000)
                r[W["STAGES"]] = 40
                r[W["PIECES"]] = 2
                r[W["TAG"]] = (first + i) << 32 | b << 8 | (role + 1)
                if producer:
                    r[W["T_EARLY_END"]] = a1[b] + 50
                    r[W["EARLY_WAIT"]] = GHZ * 400
                    r[W["EARLY_WORK"]] = GHZ * 1_500
                    r[W["EARLY"]] = 0 if b == 0 < grid - 1 else 3
                if role == 0:
                    r[W["T_BAR1_ARRIVE"]], r[W["T_BAR1_SEEN"]] = a1[b], L1 + 100
                    r[W["T_BAR2_ARRIVE"]], r[W["T_BAR2_SEEN"]] = a2[b], L2 + 200
        c = grid - 1
        stages_ns = gemm[c] - 1_200 - 600
        busy = a1[1:] if grid > 1 else a1
        want.append({"step": first + i, "span_us": (E - S) / 1e3,
                     "digit_us": (a1.mean() - S) / 1e3, "bar1_skew_us": (L1 - a1.mean()) / 1e3,
                     "bar1_release_us": (x1[c] - L1) / 1e3, "fill_us": 1.2,
                     "stages": 40, "stages_us": stages_ns / 1e3,
                     "stage_us": stages_ns / 40 / 1e3, "epilogue_us": 0.6, "bar2_us": 0.4,
                     "bar1_notice_us": 0.1, "bar2_notice_us": 0.2, "producer_fill_us": 0.9,
                     "producer_windows_us": 0.5,
                     "gemm_skew_us": (L2 - a2.mean()) / 1e3, "max_stages": 40,
                     "early_stages": 3, "early_wait_us": 0.4, "early_expand_us": 1.5,
                     "early_over_us": (busy.mean() + 50 - (L1 + 100)) / 1e3})
        S = E + 50
    return buf, want


@pytest.mark.parametrize("steps,grid", [(1, 1), (3, 4), (2, 132)])
def test_reduce_known_phases(steps, grid):
    buf, want = build(steps, grid, first=64)
    lines = sp.reduce_steps(buf)
    assert len(lines) == steps
    for got, exp in zip(lines, want):
        for key, value in exp.items():
            assert got[key] == pytest.approx(value, rel=1e-3, abs=2e-3), key
        # The critical path's parts sum to the step's span.
        assert sum(got[k] for k in sp.PARTS) == pytest.approx(got["span_us"], abs=1e-6)
    for i in range(steps - 1):
        assert lines[i]["period_us"] == pytest.approx(want[i]["span_us"] + 0.05)
    assert lines[-1]["period_us"] is None
    assert sp.clock_ghz(sp.split(buf)[1]) == pytest.approx(GHZ)
    assert sp.check_records(buf, 64 + steps) == []


def test_reduce_wait_shares():
    """Shares of the GEMM phase's cycles over all blocks, by role."""
    buf, _ = build(2, 4)
    line = sp.reduce_steps(buf)[0]
    gemm = (20_000 + 1_000 * np.arange(4) - 3).sum()      # ns, the same for every role
    assert line["producer_empty_pct"] == pytest.approx(100 * 4 * 5_000 / gemm)
    assert line["producer_window_pct"] == pytest.approx(100 * 4 * 1_000 / gemm)
    assert line["producer_expand_pct"] == pytest.approx(100 * 4 * 9_000 / gemm)
    assert line["consumer_full_pct"] == pytest.approx(100 * 4 * (2_000 + 2_100) / (2 * gemm))
    assert line["consumer_fill_pct"] == pytest.approx(100 * 4 * 1_200 / gemm)
    assert line["consumer_mma_pct"] == pytest.approx(100 * 4 * 8_000 / gemm)
    assert line["consumer_epilogue_pct"] == pytest.approx(100 * 4 * 700 / gemm)
    assert line["producer_tma_pct"] == pytest.approx(100 * 4 * 300 / gemm)
    assert line["consumer_issue_pct"] == pytest.approx(100 * 4 * 4_000 / gemm)
    assert line["producer_other_pct"] == pytest.approx(100 * (1 - 4 * 15_300 / gemm))
    assert line["consumer_other_pct"] == pytest.approx(
        100 * (1 - 4 * (2_050 + 1_200 + 4_000 + 8_000 + 700) / gemm))
    assert sp.split(buf)[0]["stamp_ns"] == 40
    assert line["record_us"] == pytest.approx(0.003)
    summary = sp.summarize(sp.reduce_steps(buf))
    assert summary["parts_us"] == pytest.approx(summary["span_us"])
    assert summary["period_us"] == pytest.approx(line["period_us"])


def test_gemm_by_walk():
    """Blocks grouped by their walk's stages and pieces, with their mean GEMM
    phase (barrier 1's exit to barrier 2's arrival)."""
    buf, _ = build(2, 4)
    rec = sp.split(buf)[1]
    rec[:, 3, 0, sp.W["PIECES"]] = 1
    rec[:, 0, 2, sp.W["PIECES"]] = 3                      # the producer's units
    got = sp.gemm_by_walk(buf)
    assert [(g["stages"], g["pieces"], g["units"], g["blocks"]) for g in got] == [
        (40, 1, 2, 2), (40, 2, 2, 4), (40, 2, 3, 2)]
    assert [g["gemm_us"] for g in got] == pytest.approx([23.0, 21.5, 20.0])
    assert got[0]["fill_us"] == pytest.approx(1.2) and got[0]["epilogue_us"] == pytest.approx(0.6)
    assert got[0]["stage_us"] == pytest.approx((23.0 - 1.8) / 40)


def test_check_records_finds_faults():
    buf, _ = build(2, 3)
    rec = sp.split(buf)[1]
    rec[1, 2, 1, sp.W["TAG"]] = 0                          # a record never written
    rec[0, 1, 0, sp.W["T_BAR1_EXIT"]] = 0                  # a stamp out of order
    rec[0, 0, 2, sp.W["STAGES"]] = 39                      # the producer's walk disagrees
    rec[1, 1, 2, sp.W["T_EARLY_END"]] = rec[1, 1, 2, sp.W["T_BAR1_EXIT"]] + 1  # early work late
    faults = sp.check_records(buf, 2)
    assert len(faults) == 4
    assert any("step 1 block 2 role 1: tag" in f for f in faults)
    assert any("step 0 block 1 role 0: stamps" in f for f in faults)
    assert any("step 1 block 1 role 2: stamps" in f for f in faults)
    assert any("ran [40, 40, 39] stages" in f for f in faults)
    assert sp.check_records(build(2, 3)[0], 1)[-1].startswith("window")


def test_layout_matches_header():
    """The Python mirror of csrc/gen_rotation.cuh's REC_* constants."""
    src = (Path(ck.CSRC) / "gen_rotation.cuh").read_text()
    consts = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int REC_(\w+) = (\d+);", src)}
    sizes = {k: consts.pop(k) for k in ("HEADER", "TICKS", "TIMER_READS", "ROLES", "WORDS")}
    assert sizes == {"HEADER": ck.REC_HEADER, "TICKS": ck.REC_TICKS,
                     "TIMER_READS": ck.REC_TIMER_READS, "ROLES": ck.REC_ROLES,
                     "WORDS": ck.REC_WORDS}
    assert consts == sp.W
    assert len(sp.WORDS) == ck.REC_WORDS
    assert 4 + ck.REC_TICKS == ck.REC_HEADER          # grid, window, ticks, stamp cost


def test_record_window(monkeypatch):
    """The steps and launches a recorder records, and the record arguments
    it hands the `_phases` entry."""
    monkeypatch.setattr(ck, "_sm_count", lambda device: 5)
    rec = ck.PhaseRecorder(range(64, 96), calls=range(1, 3))
    cpu = torch.device("cpu")
    assert rec.window("blind_rotate_gen_full", 7, 630, cpu) == ()      # call 0
    ptr, blocks, first, count = rec.window("blind_rotate_gen_full", 7, 630, cpu)
    assert (blocks, first, count) == (5, 64, 32)
    assert rec.window("cmux_step_gen", 7, 80, cpu)[2:] == (64, 16)      # clipped
    assert rec.window("cmux_step_gen", 7, 630, cpu) == ()              # call 3
    assert [(x.kernel, x.first, x.count) for x in rec.launches] == [
        ("blind_rotate_gen_full", 64, 32), ("cmux_step_gen", 64, 16)]
    assert rec.launches[0].buffer.numel() == ck.REC_HEADER + 32 * 5 * ck.REC_ROLES * ck.REC_WORDS
    assert rec.launches[0].buffer.data_ptr() == ptr
    assert ck.PhaseRecorder(range(0, 8)).window("cmux_step_gen", 1, 4, cpu)[2:] == (0, 4)
    with pytest.raises(ValueError):
        ck.PhaseRecorder(range(0, 8, 2))


def test_record_phases_leaves_cpu_path():
    """On the CPU the wrappers run their plain twins, recording or not; the
    switch is off again after the block, even after an exception."""
    p = sp_params()
    rng = np.random.default_rng(3)
    amt = torch.as_tensor(rng.integers(0, 2 * p.N, (3, 2)).astype(np.int32))
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    vv = torch.as_tensor(rng.integers(-128, 128, (2, G, C, 2 * p.N)).astype(np.int8))
    want = ck.blind_rotate_gen_full(amt, vv, 1 << 29, p)
    with ck.record_phases(range(0, 8)) as rec:
        got = ck.blind_rotate_gen_full(amt, vv, 1 << 29, p)
    assert torch.equal(got, want) and rec.launches == []
    with pytest.raises(RuntimeError), ck.record_phases(range(0, 8)):
        raise RuntimeError
    assert ck._recorder is None


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,params,B", [
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 1),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 64),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 128),
    ("blind_rotate_gen_full", "peba1_tfhe128_genf", 512),
    ("cmux_step_gen", "tfhers_bool_gen", 128)])
def test_phases_instance_matches_default(cuda_device, kernel, params, B, monkeypatch):
    """The recording instance computes the default instance's acc, bit for
    bit, and records every step of its window whole: one record per block
    and role, stamps rising, the roles' walks agreeing.  At 64 rows or fewer,
    where a call takes the narrow step, the ring is forced for both, and the
    narrow step's acc is the same."""
    import chip_smoke
    p = chip_smoke.params_of(params)
    steps = 6
    args, inplace, *_ = chip_smoke._inputs(kernel, p, B, steps, cuda_device, 11)
    wrapper = getattr(ck, kernel)

    def run():
        a = list(args)
        if inplace is not None:
            a[inplace] = a[inplace].clone()
        return wrapper(*a)

    narrow = run()
    monkeypatch.setattr(ck, "narrow_step", lambda *a: False)
    want = run()
    assert torch.equal(narrow, want)
    before = ck.launches[kernel]
    with ck.record_phases(range(1, 5)) as rec:
        got = run()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches[kernel] == before + 1 and len(rec.launches) == 1
    buffer = rec.launches[0].buffer.cpu().numpy()
    head, records = sp.split(buffer)
    assert (head["first"], head["count"]) == (1, 4)
    assert head["grid"] == torch.cuda.get_device_properties(0).multi_processor_count
    assert sp.check_records(buffer, steps) == []
    assert min(head["timer_steps_ns"]) > 0
    lines = sp.reduce_steps(buffer)
    assert all(ln["max_stages"] > 0 and ln["span_us"] > 0 for ln in lines)
