"""The program's spans (``utils/logging.span``) in a profiler's trace.

A circuit level, a lone gate and a MUX each open the five stages of a
bootstrap call once, in order and side by side; every copy of host values
to the device is a ``peba1.sync_copy`` inside the stage that makes it; each
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
from peba1_tpu_torch.utils import logging as plog

torch.set_num_threads(1)

GENF = dataclasses.replace(TOY, use_gen_step=True, use_gen_full=True)
STAGES = ["peba1.prepare", "peba1.modswitch", "peba1.rotation", "peba1.extract",
          "peba1.keyswitch"]
# Host copies each stage makes: the gate weights of a level (one list) or of
# a lone gate (wa, wb, offset); the keyswitch's digit shifts and limb
# shifts; on the CPU the plain twin of the rotation makes three a CMUX step
# (`decompose`'s shifts, the limb plan's groups and shifts), none on a card.
COPIES = {"level": {"peba1.prepare": 1, "peba1.rotation": 3 * GENF.n, "peba1.keyswitch": 2},
          "gate": {"peba1.prepare": 3, "peba1.rotation": 3 * GENF.n, "peba1.keyswitch": 2},
          "mux": {"peba1.rotation": 3 * GENF.n, "peba1.keyswitch": 2}}


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


@pytest.fixture(scope="module")
def traced():
    """Each call kind run untraced, then traced on the same inputs:
    {kind: (untraced outputs, traced outputs, spans)}."""
    sk, ck = keys.keygen(torch.Generator().manual_seed(3), GENF, "cpu")
    g = torch.Generator().manual_seed(4)
    x, y, z = (gates.encrypt_bits(g, sk, torch.tensor(bits))
               for bits in ([0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]))
    be = CipherBackend(ck)
    out = {}
    for kind, call in _calls(be, x, y, z).items():
        plain = _outputs(call())
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            again = _outputs(call())
        out[kind] = (plain, again, _spans(prof))
    return out


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
    spans = traced[kind][2]
    by_stage: dict = {}
    for (name, start, end), parent in zip(spans, _parents(spans)):
        if name == "peba1.sync_copy":
            stage = next(s for s, s0, s1 in spans if s in STAGES and s0 <= start and end <= s1)
            by_stage[stage] = by_stage.get(stage, 0) + 1
            assert parent in (stage, "peba1.kernel.blind_rotate_gen_full")
    assert by_stage == COPIES[kind]


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_the_rotation_kernel_sits_inside_the_rotation(traced, kind):
    spans = traced[kind][2]
    kernels = [(name, p) for (name, _, _), p in zip(spans, _parents(spans))
               if name.startswith("peba1.kernel.")]
    assert kernels == [("peba1.kernel.blind_rotate_gen_full", "peba1.rotation")]


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_outputs_are_the_same_bits_traced_or_not(traced, kind):
    plain, again, _ = traced[kind]
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
