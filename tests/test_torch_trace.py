"""The program's spans (``utils/logging.span``) in a profiler's trace.

A circuit level, a lone gate and a MUX each open the five stages of a
bootstrap call once, in order and side by side; every upload of host
values to the device (a miss of the constants it keeps there) is a
``peba1.sync_copy`` inside the stage that makes it, and a warmed call makes
none; each
kernel wrapper is a ``peba1.kernel.<wrapper>`` span.  With no profiler on a
span is one shared no-op, and the outputs are the same bits traced or not.
The parameters are the toy set at the benchmark configuration's kernel flags
(one `blind_rotate_gen_full` call a bootstrap, its plain twin on the CPU).
"""

import dataclasses

import pytest
import torch

from peba1_tpu_torch import gates
from peba1_tpu_torch import keys
from peba1_tpu_torch.backends import CipherBackend
from peba1_tpu_torch.params import TOY
from peba1_tpu_torch.utils import device
from peba1_tpu_torch.utils import logging as plog

torch.set_num_threads(1)

GENF = dataclasses.replace(TOY, use_gen_step=True, use_gen_full=True)
STAGES = ["peba1.prepare", "peba1.modswitch", "peba1.rotation", "peba1.extract",
          "peba1.keyswitch"]
# Uploads (``peba1.sync_copy``, a miss of `utils.device.from_host`'s
# constants) each stage of a call makes on a cold cache: the gate weights of
# a level (one list) or of a lone gate (NAND's -1, -1, MU_1_8: two distinct
# values); the keyswitch's digit shifts and limb shifts; on the CPU the
# plain twin of the rotation's first CMUX step (`decompose`'s shifts, the
# limb plan's groups and shifts), whose later steps hit.  A second call of
# the same kind makes none.
COLD_UPLOADS = {"level": {"peba1.prepare": 1, "peba1.rotation": 3, "peba1.keyswitch": 2},
                "gate": {"peba1.prepare": 2, "peba1.rotation": 3, "peba1.keyswitch": 2},
                "mux": {"peba1.rotation": 3, "peba1.keyswitch": 2}}


def _calls(be, x, y, z):
    return {"level": lambda: be.level([("AND", x, y), ("XOR", y, z)]),
            "gate": lambda: be.gate("NAND", x, z),
            "mux": lambda: be.MUX(x, y, z)}


def _outputs(out):
    outs = out if isinstance(out, list) else [out]
    return [t for o in outs for t in (o.a, o.b)]


def _spans(prof) -> "list[tuple[str, float, float]]":
    """(name, start, end) of the program's spans, in the order they opened."""
    evs = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(plog.SPAN_PREFIX)]
    return sorted(evs, key=lambda s: (s[1], -s[2]))


def _parents(spans) -> "list[str | None]":
    """For each span, the name of the innermost other span around it."""
    out, stack = [], []
    for name, start, end in spans:
        while stack and stack[-1][2] <= start:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
        stack.append((name, start, end))
    return out


def _traced(call):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _outputs(call())
    return out, _spans(prof)


@pytest.fixture(scope="module")
def traced():
    """Each call kind run untraced, then traced on the same inputs, then
    traced again on a cold cache of host constants: {kind: (untraced
    outputs, traced outputs, spans, cold outputs, cold spans)}."""
    sk, ck = keys.keygen(torch.Generator().manual_seed(3), GENF, "cpu")
    g = torch.Generator().manual_seed(4)
    x, y, z = (gates.encrypt_bits(g, sk, torch.tensor(bits))
               for bits in ([0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]))
    be = CipherBackend(ck)
    out = {}
    for kind, call in _calls(be, x, y, z).items():
        plain = _outputs(call())
        again, spans = _traced(call)
        device.forget_constants()
        cold, cold_spans = _traced(call)
        out[kind] = (plain, again, spans, cold, cold_spans)
    return out


def _uploads_by_stage(spans) -> dict:
    """{stage: its ``peba1.sync_copy`` spans}; each directly inside its stage
    or inside the rotation's kernel wrapper (the plain twin on the CPU)."""
    by_stage: dict = {}
    for (name, start, end), parent in zip(spans, _parents(spans)):
        if name == "peba1.sync_copy":
            stage = next(s for s, s0, s1 in spans if s in STAGES and s0 <= start and end <= s1)
            by_stage[stage] = by_stage.get(stage, 0) + 1
            assert parent in (stage, "peba1.kernel.blind_rotate_gen_full")
    return by_stage


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_a_call_opens_the_five_stages_in_order(traced, kind):
    spans = traced[kind][2]
    parents = _parents(spans)
    stages = [name for name, _, _ in spans if name in STAGES]
    assert stages == STAGES
    # Siblings: no stage inside another, and no span outside every stage.
    assert all(p is None for (name, _, _), p in zip(spans, parents) if name in STAGES)
    assert all(p is not None for (name, _, _), p in zip(spans, parents) if name not in STAGES)


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_sync_copies_by_stage(traced, kind):
    """The untraced first call kept every host constant on the device, so
    the same call traced makes no ``peba1.sync_copy``."""
    assert _uploads_by_stage(traced[kind][2]) == {}


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_a_cold_call_uploads_under_the_stage_that_makes_them(traced, kind):
    _, again, _, cold, cold_spans = traced[kind]
    assert _uploads_by_stage(cold_spans) == COLD_UPLOADS[kind]
    assert all(torch.equal(a, b) for a, b in zip(again, cold))


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_the_rotation_kernel_sits_inside_the_rotation(traced, kind):
    spans = traced[kind][2]
    kernels = [(name, p) for (name, _, _), p in zip(spans, _parents(spans))
               if name.startswith("peba1.kernel.")]
    assert kernels == [("peba1.kernel.blind_rotate_gen_full", "peba1.rotation")]


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_outputs_are_the_same_bits_traced_or_not(traced, kind):
    plain, again = traced[kind][:2]
    assert len(plain) == len(again)
    assert all(torch.equal(a, b) for a, b in zip(plain, again))


def test_a_span_is_a_shared_noop_with_no_profiler():
    assert not torch.autograd._profiler_enabled()
    assert plog.span("prepare") is plog.NO_SPAN
    assert plog.span("keyswitch") is plog.NO_SPAN
    with plog.span("prepare") as inside:
        assert inside is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert plog.span("prepare") is not plog.NO_SPAN


def test_event_log_timer_opens_its_span():
    log = plog.EventLog()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with log.timer("sweep_chunk", chunk=0):
            torch.ones(4).sum()
    assert [name for name, _, _ in _spans(prof)] == ["peba1.sweep_chunk"]
