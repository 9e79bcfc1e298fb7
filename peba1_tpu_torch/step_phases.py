"""Where a CMUX step of kernels 1 and 2 spends its time: their recording
instance's records, reduced to one line a step.

    python -m peba1_tpu_torch.step_phases [--out H100_PHASES.json]

On the card, the tool runs kernel 2 (`blind_rotate_gen_full`) at the
benchmark cells' lattice (``chip_smoke``'s ``peba1_tfhe128_genf``) at
`K2_ROWS`, each at 8 steps (``kernel_ab``'s calls: the key's steps stay in
L2) and at a whole 630-step call (the key streams from device memory);
kernel 1 (`cmux_step_gen`) at ``tfhers_bool_gen`` at `K1_ROWS`, at 8 steps
and a whole 722-step call; and calls 200-399 of one authentication at the
cells' lattice and protocol (the benchmark's traced slice of
``auth1_tfhe128``).  Each shape runs the default instance and the recording
one on the same inputs (their acc must be bit-equal) and times both on the
card alone (``chip_smoke.device_ms``).  Prints the card's name and power
limit, then one JSON line a shape (the mean of its steps' lines, the
blocks' GEMM phases by walk, the periods by place in the call); writes
every line to `--out`.  A shape of `cuda_kernels.NARROW_MAX_ROWS` rows or
fewer takes the narrow step (``csrc/narrow_rotation.cuh``), which has no
recording instance: its line gives its time a step from CUDA events and
says that it has no phase records.  The authentication's line counts the
calls that took the narrow step against its calls of that many rows.

A step of kernels 1 and 2 (``csrc/gen_rotation.cuh``): a digit phase, grid
barrier 1, a GEMM phase (the producer warpgroup fills a ring of stages that
consumer warpgroups 0 and 1 multiply; each piece of a work item ends in an
epilogue of adds into acc), grid barrier 2.  `reduce_steps` splits the
step's critical path, from the first block's start S to the last block's
exit from barrier 2 E, into parts that sum to E - S:

  digit          the mean block's digit phase (its arrival at barrier 1 - S);
  bar1_skew      the last block's arrival at barrier 1 after the mean block's;
  bar1_release   from that last arrival until the critical block c (the last
                 to arrive at barrier 2) leaves barrier 1;
  fill           c's consumers: barrier 1's exit to their first full stage;
  stages         c's stages, `stage_us` each: the GEMM phase less fill and
                 epilogue over c's stage count (the epilogues of c's earlier
                 pieces fall in it);
  epilogue       c's consumers' last epilogue (the adds after their last
                 stage);
  bar2           from c's arrival at barrier 2 until the last block leaves.

Beside them, over all blocks, shares of the GEMM phase's cycles: the
producer waiting on the consumers (``empty``), on its generator windows
(``cp.async``), expanding weight tiles, issuing the digit tile's TMA (the
recorded producer thread is the one that issues it) and the rest (its
arrivals and the walk); the consumers waiting on the producer or the TMA
(``full``, after the fill), issuing their ``wgmma``, waiting on them, in
their epilogues, and the rest (their releases and the walk).  Also the
critical block's producer fill (barrier 1's exit to its first arrival) and
its time from barrier 1's exit until its second unit's generator windows
had landed, and `record_us`, the mean block's time from its roles' last
GEMM end to its arrival at barrier 2, in which the recording threads store
the step's record (the recording's own cost on the critical path, with the
stamps).

The producer's work before barrier 1's end (``expand_early``: it arrives at
the barrier without waiting, awaits its first unit's windows, fetched as
the step began, and expands the ring's first weight tiles while thread 0
waits for the grid): the critical block's stages so expanded and its µs
awaiting the windows and expanding (`early_*`), and `early_over_us`, over
the blocks that expanded any, how long after thread 0 saw the last block
arrive the producer's early work ended (negative: inside the barrier's
wait; positive: the producer held its block at the barrier).
The SM clock turns cycles into time at the rate the records give (GEMM
cycles over the timer's ns).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

from .ops.cuda_kernels import REC_HEADER, REC_ROLES, REC_TICKS, REC_TIMER_READS, REC_WORDS

# The words of a record, in order (``csrc/gen_rotation.cuh``'s REC_*).
WORDS = ("T_START", "T_DIGITS", "T_BAR1_ARRIVE", "T_BAR1_SEEN", "T_BAR1_EXIT", "T_GEMM_END",
         "T_BAR2_ARRIVE", "T_BAR2_SEEN", "T_BAR2_EXIT", "GEMM_CYCLES", "FILL", "WAIT", "WAIT2",
         "WORK", "LAST", "ISSUE", "STAGES", "PIECES", "TAG", "T_EARLY_END", "EARLY_WAIT",
         "EARLY_WORK", "EARLY")
W = {name: i for i, name in enumerate(WORDS)}
CONSUMERS, PRODUCER = (0, 1), 2        # roles: consumer warpgroups 0 and 1, the producer

K2_PARAMS, K2_STEPS = "peba1_tfhe128_genf", 630
K2_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 8192)
K1_PARAMS, K1_ROWS, K1_STEPS = "tfhers_bool_gen", (1, 8, 64, 128, 8192), 722
WINDOW = range(64, 96)                 # the steps recorded of a whole call
AUTH_CALLS = range(200, 400)           # the benchmark's traced slice of auth1_tfhe128
SEED = 0                               # inputs and keys of every shape


def split(buffer) -> "tuple[dict, np.ndarray]":
    """(header, records) of one launch's record buffer: the header's grid,
    window, timer steps and the ns a stamp costs (a timer read and the store
    that waits for it), and the records as int64 (count, grid, roles,
    words)."""
    buf = np.asarray(buffer, dtype=np.int64)
    grid, first, count = (int(x) for x in buf[:3])
    head = {"grid": grid, "first": first, "count": count,
            "timer_steps_ns": [int(x) for x in buf[3:3 + REC_TICKS]],
            "stamp_ns": float(buf[3 + REC_TICKS]) / REC_TIMER_READS}
    n = count * grid * REC_ROLES * REC_WORDS
    return head, buf[REC_HEADER:REC_HEADER + n].reshape(count, grid, REC_ROLES, REC_WORDS)


def clock_ghz(rec: np.ndarray) -> float:
    """The SM clock over the records: GEMM-phase cycles over the timer's ns
    between barrier 1's exit and the GEMM phase's end, every block and role."""
    ns = rec[..., W["T_GEMM_END"]] - rec[..., W["T_BAR1_EXIT"]]
    return float(rec[..., W["GEMM_CYCLES"]].sum() / ns.sum())


def _share(rec: np.ndarray, roles: tuple, word: str) -> float:
    """Percent of the GEMM phase's cycles that `roles` spent in `word`, over
    all blocks of one step's records (blocks, roles, words)."""
    r = rec[:, list(roles)]
    return float(100.0 * r[..., W[word]].sum() / r[..., W["GEMM_CYCLES"]].sum())


def reduce_steps(buffer) -> "list[dict]":
    """One line a recorded step (module docstring): the critical path's parts
    in µs, the critical block's stages, the walk's most stages of a block,
    the period to the next step's start, and the GEMM phase's shares."""
    head, rec = split(buffer)
    ghz = clock_ghz(rec)
    us = 1e-3
    lines = []
    for i in range(head["count"]):
        r = rec[i]                                          # (grid, roles, words)
        start = r[:, :, W["T_START"]].min(axis=1)
        S = int(start.min())
        a1, a2 = r[:, 0, W["T_BAR1_ARRIVE"]], r[:, 0, W["T_BAR2_ARRIVE"]]
        x1, x2 = r[:, :, W["T_BAR1_EXIT"]].max(axis=1), r[:, :, W["T_BAR2_EXIT"]].max(axis=1)
        L1, c = int(a1.max()), int(a2.argmax())
        L2, E = int(a2[c]), int(x2.max())
        cons = r[c, list(CONSUMERS)]
        fill = cons[:, W["FILL"]].max() / ghz
        epi = cons[:, W["LAST"]].max() / ghz
        gemm = L2 - int(x1[c])
        stages = int(r[c, 0, W["STAGES"]])
        busy = r[:, PRODUCER, W["EARLY"]] > 0
        line = {
            "step": head["first"] + i,
            "span_us": (E - S) * us,
            "digit_us": (a1.mean() - S) * us,
            "bar1_skew_us": (L1 - a1.mean()) * us,
            "bar1_release_us": (int(x1[c]) - L1) * us,
            "fill_us": fill * us,
            "stages": stages,
            "stages_us": (gemm - fill - epi) * us,
            "stage_us": (gemm - fill - epi) / max(stages, 1) * us,
            "epilogue_us": epi * us,
            "bar2_us": (E - L2) * us,
            "bar1_notice_us": (r[:, 0, W["T_BAR1_SEEN"]].mean() - L1) * us,
            "bar2_notice_us": (r[:, 0, W["T_BAR2_SEEN"]].mean() - L2) * us,
            "gemm_skew_us": (L2 - a2.mean()) * us,
            "record_us": (a2 - r[:, :, W["T_GEMM_END"]].max(axis=1)).mean() * us,
            "max_stages": int(r[:, 0, W["STAGES"]].max()),
            "period_us": (int(rec[i + 1, :, :, W["T_START"]].min()) - S) * us
            if i + 1 < head["count"] else None,
            "producer_fill_us": r[c, PRODUCER, W["FILL"]] / ghz * us,
            "producer_windows_us": r[c, PRODUCER, W["LAST"]] / ghz * us,
            "early_stages": int(r[c, PRODUCER, W["EARLY"]]),
            "early_wait_us": r[c, PRODUCER, W["EARLY_WAIT"]] / ghz * us,
            "early_expand_us": r[c, PRODUCER, W["EARLY_WORK"]] / ghz * us,
            "early_over_us": float((r[busy, PRODUCER, W["T_EARLY_END"]]
                                    - r[busy, 0, W["T_BAR1_SEEN"]]).mean()) * us
            if busy.any() else None,
            "producer_empty_pct": _share(r, (PRODUCER,), "WAIT"),
            "producer_window_pct": _share(r, (PRODUCER,), "WAIT2"),
            "producer_expand_pct": _share(r, (PRODUCER,), "WORK"),
            "producer_tma_pct": _share(r, (PRODUCER,), "ISSUE"),
            "consumer_full_pct": _share(r, CONSUMERS, "WAIT"),
            "consumer_fill_pct": _share(r, CONSUMERS, "FILL"),
            "consumer_issue_pct": _share(r, CONSUMERS, "ISSUE"),
            "consumer_mma_pct": _share(r, CONSUMERS, "WAIT2"),
            "consumer_epilogue_pct": _share(r, CONSUMERS, "WORK"),
        }
        line["producer_other_pct"] = 100.0 - sum(
            line[f"producer_{k}_pct"] for k in ("empty", "window", "expand", "tma"))
        line["consumer_other_pct"] = 100.0 - sum(
            line[f"consumer_{k}_pct"] for k in ("full", "fill", "issue", "mma", "epilogue"))
        lines.append(line)
    return lines


PARTS = ("digit_us", "bar1_skew_us", "bar1_release_us", "fill_us", "stages_us", "epilogue_us",
         "bar2_us")


def summarize(lines: "list[dict]") -> dict:
    """The mean of every number over the steps (`period_us` over the steps
    that have one), and `parts_us`, the critical path's parts summed."""
    out = {}
    for key in lines[0]:
        vals = [ln[key] for ln in lines if ln[key] is not None]
        if key != "step":
            out[key] = statistics.fmean(vals) if vals else None
    out["parts_us"] = sum(out[k] for k in PARTS)
    return out


def gemm_by_walk(buffer) -> "list[dict]":
    """The blocks' GEMM phases (barrier 1's exit to barrier 2's arrival),
    grouped by the walk they ran: its stages, the consumers' pieces and the
    producer's units (generator windows fetched).  For each group, over
    every recorded step: the blocks, and the mean GEMM phase, consumer fill,
    last epilogue and µs a stage (the GEMM phase less both, over the
    stages), all µs.  What a stage, a piece or a unit adds on one block."""
    _, rec = split(buffer)
    ghz = clock_ghz(rec)
    cons = rec[:, :, list(CONSUMERS)]
    gemm = (rec[:, :, 0, W["T_BAR2_ARRIVE"]] - rec[..., W["T_BAR1_EXIT"]].max(axis=2)) * 1e-3
    fill = cons[..., W["FILL"]].max(axis=2) / ghz * 1e-3
    epi = cons[..., W["LAST"]].max(axis=2) / ghz * 1e-3
    walk = np.stack([rec[:, :, 0, W["STAGES"]], rec[:, :, 0, W["PIECES"]],
                     rec[:, :, PRODUCER, W["PIECES"]]], axis=-1).reshape(-1, 3)
    out = []
    for key in sorted({tuple(k) for k in walk.tolist()}):
        m = (walk == key).all(axis=1)
        g, f, e = gemm.ravel()[m].mean(), fill.ravel()[m].mean(), epi.ravel()[m].mean()
        out.append({"stages": key[0], "pieces": key[1], "units": key[2], "blocks": int(m.sum()),
                    "gemm_us": float(g), "fill_us": float(f), "epilogue_us": float(e),
                    "stage_us": float((g - f - e) / max(key[0], 1))})
    return out


def check_records(buffer, n_steps: int) -> "list[str]":
    """What is wrong with one launch's records, as text (nothing if sound):
    one record per recorded step, block and role, tagged with its own
    place; stamps rising within a record; the roles' walks agreeing."""
    head, rec = split(buffer)
    faults = []
    for i in range(head["count"]):
        for b in range(head["grid"]):
            for role in range(REC_ROLES):
                r = rec[i, b, role]
                want = (head["first"] + i) << 32 | b << 8 | (role + 1)
                if int(r[W["TAG"]]) != want:
                    faults.append(f"step {head['first'] + i} block {b} role {role}: tag "
                                  f"{int(r[W['TAG']]):#x}, want {want:#x}")
                    continue
                order = ["T_START", "T_DIGITS"] + (["T_BAR1_ARRIVE", "T_BAR1_SEEN"]
                                                   if role == 0 else []) + (
                    ["T_EARLY_END"] if role == PRODUCER else []) + [
                    "T_BAR1_EXIT", "T_GEMM_END"] + (["T_BAR2_ARRIVE", "T_BAR2_SEEN"]
                                                    if role == 0 else []) + ["T_BAR2_EXIT"]
                t = [int(r[W[k]]) for k in order]
                if any(u > v for u, v in zip(t, t[1:])) or t[0] <= 0:
                    faults.append(f"step {head['first'] + i} block {b} role {role}: stamps "
                                  f"{dict(zip(order, t))} do not rise")
            if len({int(x) for x in rec[i, b, :, W["STAGES"]]}) != 1:
                faults.append(f"step {head['first'] + i} block {b}: the roles ran "
                              f"{rec[i, b, :, W['STAGES']].tolist()} stages")
    if head["first"] + head["count"] > n_steps:
        faults.append(f"window {head['first']}+{head['count']} past the launch's {n_steps} steps")
    return faults


# --- on the card ------------------------------------------------------------

def _ptxas(stem: str) -> "list[str]":
    """ptxas's register and spill lines for csrc/<stem>.cu's kernels, in the
    order it compiled them."""
    from .ops import cuda_kernels as ck
    text = (ck.build()[stem].parent / f"{stem}.ptxas.txt").read_text()
    return [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def _shape(smoke, kernel: str, params: str, B: int, steps: int, window: range,
           device, seed: int) -> dict:
    """One shape: the default and recording instances on the same inputs,
    bit-equal; both timed on the card alone, the recording one also with
    every step recorded (`record_cost_us`: what recording adds to a step);
    the records of `window` reduced."""
    import torch
    from .ops import cuda_kernels as ck
    p = smoke.params_of(params)
    args, inplace, *_ = smoke._inputs(kernel, p, B, steps, device, seed)
    wrapper = getattr(ck, kernel)
    if ck.narrow_step(B):
        a = list(args)
        ms = smoke.device_ms(lambda: wrapper(*a), 3 if B * steps > 500_000 else 10) / steps
        return {"kernel": kernel, "params": params, "B": B, "steps": steps, "narrow": True,
                "default_device_ms": ms, "step_us": ms * 1e3,
                "records": "none: the narrow step (csrc/narrow_rotation.cuh) has no "
                           "recording instance; its time a step is from CUDA events"}

    def call(record: "range | None"):
        a = list(args)
        if inplace is not None:
            a[inplace] = a[inplace].clone()
        if record is None:
            return wrapper(*a), None
        with ck.record_phases(record) as rec:
            out = wrapper(*a)
        return out, rec.launches[0]

    reps = 3 if B * steps > 500_000 else 10
    default_ms = smoke.device_ms(lambda: call(None), reps) / steps
    phases_ms = smoke.device_ms(lambda: call(window), reps) / steps
    every = range(0, steps)
    all_ms = (phases_ms if window == every
              else smoke.device_ms(lambda: call(every), reps) / steps)
    # The records read, on a card warmed by the timings above (the first
    # recorded call of a shape ran its window up to 5% slower).
    want, _ = call(None)
    got, launch = call(window)
    torch.cuda.synchronize(device)
    if not torch.equal(got, want):
        raise SystemExit(f"{kernel} {params} B={B}: the recording instance's acc differs")
    buffer = launch.buffer.cpu().numpy()
    faults = check_records(buffer, steps)
    if faults:
        raise SystemExit(f"{kernel} {params} B={B}: " + "; ".join(faults[:5]))
    # Every step of the call recorded: the mean period before, in and after
    # the window (a step's place in the call, against the window's).
    periods = [ln["period_us"] for ln in reduce_steps(call(every)[1].buffer.cpu().numpy())
               if ln["period_us"] is not None]
    cuts = [0, window.start, min(window.stop, steps) - 1, len(periods)]
    by_place = {f"{a}-{b}": statistics.fmean(periods[a:b])
                for a, b in zip(cuts, cuts[1:]) if b > a}
    lines = reduce_steps(buffer)
    window_periods = [ln["period_us"] or ln["span_us"] for ln in lines]
    head, rec = split(buffer)
    summary = summarize(lines)
    period = summary["period_us"] or summary["span_us"]
    return {"kernel": kernel, "params": params, "B": B, "steps": steps,
            "window": [window.start, min(window.stop, steps)], "grid": head["grid"],
            "timer_steps_ns": head["timer_steps_ns"],
            "stamp_ns": head["stamp_ns"], "clock_ghz": clock_ghz(rec),
            "default_device_ms": default_ms, "phases_device_ms": phases_ms,
            "perturbation_pct": 100.0 * (phases_ms / default_ms - 1.0),
            "record_cost_us": (all_ms - default_ms) * 1e3, "period_by_place_us": by_place,
            "period_vs_default_pct": 100.0 * (period * 1e-3 / default_ms - 1.0),
            "parts_vs_default_pct": 100.0 * (summary["parts_us"] * 1e-3 / default_ms - 1.0),
            "summary": summary, "gemm_by_walk": gemm_by_walk(buffer),
            "period_range_us": [min(window_periods), max(window_periods)]}


def _auth(smoke, device, seed: int) -> dict:
    """One authentication at the cells' lattice and protocol, twice: the
    default instance, then with calls `AUTH_CALLS` recording `WINDOW`.  Each
    run's kernel-2 calls of the slice are timed with CUDA events; each
    recorded call's phases a step are scaled to its 630 steps and summed."""
    import torch
    from . import keys
    from .ops import cuda_kernels as ck
    from .params import ProtocolParams
    from .protocol import ClientDevice, Server
    p = smoke.params_of(K2_PARAMS)
    proto = ProtocolParams(nslots=128, bitsize=8, max_bitsize=24, mul_width=23,
                           bound_match=256)
    sk, cloud = keys.keygen(torch.Generator(device=device).manual_seed(seed), p, device)
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 256, proto.nslots)
    probe = np.clip(template + rng.integers(-1, 2, proto.nslots), 0, 255)
    want_b = int(((probe - template) ** 2).sum() > proto.bound_match)
    client, server = ClientDevice(7, sk, cloud, proto), Server(cloud, proto)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    enc = (client.encrypt_vector(gen, probe), client.encrypt_vector(gen, template),
           client.encrypt_word(gen, proto.bound_match, 3 * proto.bitsize))
    wrapped = ck.blind_rotate_gen_full
    runs = {}
    for label in ("default", "phases"):
        events, rows = [], []

        def timed(*a, **kw):
            """The wrapper, its calls of the slice between CUDA events."""
            i = len(rows)
            rows.append(a[0].shape[1])
            if i not in AUTH_CALLS:
                return wrapped(*a, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapped(*a, **kw)
            end.record()
            events.append((start, end))
            return out

        ck.blind_rotate_gen_full = timed
        try:
            g_auth = torch.Generator(device=device).manual_seed(seed + 2)
            ck.reset_launches()
            if label == "phases":
                with ck.record_phases(WINDOW, calls=AUTH_CALLS) as rec:
                    res = server.authenticate(g_auth, *enc)
            else:
                res = server.authenticate(g_auth, *enc)
            torch.cuda.synchronize(device)
        finally:
            ck.blind_rotate_gen_full = wrapped
        b = int(np.asarray(client.decrypt_word(res.enc_b)).reshape(-1)[0])
        if b != want_b:
            raise SystemExit(f"auth ({label}): decision {b}, want {want_b}")
        narrow_rows = sum(ck.narrow_step(B) for B in rows)
        if ck.narrow_calls["blind_rotate_gen_full"] != narrow_rows:
            raise SystemExit(f"auth ({label}): {ck.narrow_calls} narrow calls, want "
                             f"{narrow_rows} (its calls of {ck.NARROW_MAX_ROWS} rows or fewer)")
        runs[label] = {"calls": len(rows), "b": b,
                       "narrow_calls": ck.narrow_calls["blind_rotate_gen_full"],
                       "slice_kernel_s": sum(s.elapsed_time(e) for s, e in events) * 1e-3,
                       "slice_rows": rows[AUTH_CALLS.start:AUTH_CALLS.stop]}
    totals = {k: 0.0 for k in PARTS}
    by_rows: "dict[int, list]" = {}
    for launch in rec.launches:
        buffer = launch.buffer.cpu().numpy()
        faults = check_records(buffer, launch.n_steps)
        if faults:
            raise SystemExit("auth: " + "; ".join(faults[:5]))
        summary = summarize(reduce_steps(buffer))
        for k in PARTS:
            totals[k] += summary[k] * 1e-6 * launch.n_steps
        by_rows.setdefault(launch.B, []).append(summary)
    return {"kernel": "blind_rotate_gen_full", "params": K2_PARAMS, "auth_calls":
            [AUTH_CALLS.start, AUTH_CALLS.stop], "window": [WINDOW.start, WINDOW.stop],
            "runs": {k: {kk: vv for kk, vv in v.items() if kk != "slice_rows"}
                     for k, v in runs.items()},
            "slice_rows_mean": statistics.fmean(runs["default"]["slice_rows"]),
            "recorded_calls": len(rec.launches),
            "parts_s": totals, "parts_total_s": sum(totals.values()),
            "by_rows": {B: {"calls": len(s), **{k: statistics.fmean(v) for k in s[0]
                                               if (v := [x[k] for x in s if x[k] is not None])}}
                        for B, s in sorted(by_rows.items())}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="H100_PHASES.json")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_phases: needs an NVIDIA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as smoke
    device = torch.device("cuda", 0)
    card = smoke.card_label(device)
    print(card, flush=True)
    record = {"card": card, "ptxas": {stem: _ptxas(stem) for stem in (
                  "blind_rotate_gen_full", "blind_rotate_gen_full_phases",
                  "blind_rotate_gen_full_narrow", "cmux_step_gen", "cmux_step_gen_phases",
                  "cmux_step_gen_narrow")},
              "shapes": []}
    print(json.dumps({"ptxas": record["ptxas"]}), flush=True)
    shapes = ([("blind_rotate_gen_full", K2_PARAMS, B, s, range(0, 8) if s == 8 else WINDOW)
               for B in K2_ROWS for s in (8, K2_STEPS)]
              + [("cmux_step_gen", K1_PARAMS, B, s, range(0, 8) if s == 8 else WINDOW)
                 for B in K1_ROWS for s in (8, K1_STEPS)])
    for kernel, params, B, steps, window in shapes:
        line = _shape(smoke, kernel, params, B, steps, window, device, SEED)
        record["shapes"].append(line)
        print(json.dumps(line), flush=True)
        smoke.free_device_memory()
    record["auth"] = _auth(smoke, device, SEED)
    print(json.dumps(record["auth"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
