"""Host constants kept on the device by value (``utils/device.from_host``).

Equal values with the same dtype and device give the same tensor; a hit
costs a lookup and uploads nothing, so a warmed bootstrap call makes no
upload (on a card: never waits for the stream).  The cache is bounded,
least recently used out: values seen once cannot push out those every call
uses again.  No caller writes a kept tensor in place, and a hit on one
written since is refused.  The parameters are the toy set at the benchmark
configuration's kernel flags (one `blind_rotate_gen_full` a call, its plain
twin on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from peba1_tpu_torch import gates, keys
from peba1_tpu_torch.backends import CipherBackend
from peba1_tpu_torch.ops import bootstrap as bs
from peba1_tpu_torch.params import TOY
from peba1_tpu_torch.utils import device

torch.set_num_threads(1)

GENF = dataclasses.replace(TOY, use_gen_step=True, use_gen_full=True)
CPU = torch.device("cpu")


@pytest.fixture
def cold():
    device.forget_constants()
    device.reset_uploads()
    yield
    device.forget_constants()


@pytest.fixture(scope="module")
def system():
    sk, ck = keys.keygen(torch.Generator().manual_seed(5), GENF, "cpu")
    g = torch.Generator().manual_seed(6)
    x, y, z = (gates.encrypt_bits(g, sk, torch.tensor(bits))
               for bits in ([0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]))
    return sk, ck, (x, y, z)


def _calls(be, x, y, z):
    return {"level": lambda: be.level([("AND", x, y), ("XOR", y, z), ("ORNY", x, z)]),
            "gate": lambda: be.gate("NAND", x, z),
            "mux": lambda: be.MUX(x, y, z)}


def _bits(out):
    return [t for o in (out if isinstance(out, list) else [out]) for t in (o.a, o.b)]


def _kept() -> "list[torch.Tensor]":
    return [t for t, _ in device._kept.values()]


@pytest.mark.parametrize("values", [[3, -1, 7], (3, -1, 7), [(1, 1, -5), (2, 2, 9)], 12,
                                    np.arange(6, dtype=np.int64).reshape(2, 3)])
def test_equal_values_give_the_same_tensor(cold, values):
    first = device.from_host(values, torch.int32, CPU)
    again = device.from_host(values, torch.int32, "cpu")
    assert again is first
    assert torch.equal(first, torch.as_tensor(values, dtype=torch.int32))
    assert device.uploads == {"hits": 1, "misses": 1}


@pytest.mark.parametrize("other", [
    ([3, -1, 8], torch.int32, "cpu"),          # values
    ([3, -1, 7], torch.int64, "cpu"),          # dtype
    ([[3, -1, 7]], torch.int32, "cpu"),        # shape
    ([3, -1, 7], torch.int32, "meta"),         # device
])
def test_other_values_dtype_shape_or_device_give_another(cold, other):
    first = device.from_host([3, -1, 7], torch.int32, "cpu")
    values, dtype, dev = other
    second = device.from_host(values, dtype, dev)
    assert second is not first
    assert (second.dtype, tuple(second.shape), second.device.type) == (
        dtype, tuple(np.shape(values)), dev)
    assert device.uploads == {"hits": 0, "misses": 2}


def test_arrays_are_keyed_by_content_not_identity(cold):
    a = np.array([5, 6, 7], np.int32)
    first = device.from_host(a, torch.int32, CPU)
    assert device.from_host(a.copy(), torch.int32, CPU) is first
    a[0] = 9                                   # the same array, new content
    second = device.from_host(a, torch.int32, CPU)
    assert second is not first
    assert first.tolist() == [5, 6, 7] and second.tolist() == [9, 6, 7]
    # Same bytes, other array dtype or shape: another key.
    assert device.from_host(np.array([5, 6, 7], np.int64), torch.int32, CPU) is not first
    assert device.from_host(np.array([[5, 6, 7]], np.int32), torch.int32, CPU) is not first


def test_floats_are_keyed_by_their_bits(cold):
    pos = device.from_host([0.0, 1.5], torch.float32, CPU)
    neg = device.from_host([-0.0, 1.5], torch.float32, CPU)
    assert neg is not pos
    assert torch.signbit(neg[0]) and not torch.signbit(pos[0])


def test_a_tensor_is_only_moved_and_cast(cold):
    t = torch.tensor([1, 2], dtype=torch.int64)
    assert device.from_host(t, torch.int64, CPU) is t
    assert device.from_host(t, torch.int32, CPU).dtype == torch.int32
    assert device.uploads == {"hits": 0, "misses": 0}


def test_hits_and_misses_count(cold):
    for _ in range(3):
        device.from_host([1, 2], torch.int32, CPU)
    device.from_host(7, torch.int64, CPU)
    assert device.uploads == {"hits": 2, "misses": 2}
    device.reset_uploads()
    assert device.uploads == {"hits": 0, "misses": 0}


def test_the_bound_evicts_the_least_recently_used(cold, monkeypatch):
    monkeypatch.setattr(device, "KEPT_ENTRIES", 3)
    first = {v: device.from_host(v, torch.int32, CPU) for v in range(3)}
    device.from_host(0, torch.int32, CPU)           # order 1, 2, 0
    device.from_host(3, torch.int32, CPU)           # 1, the least recent, goes
    device.reset_uploads()
    assert device.from_host(0, torch.int32, CPU) is first[0]
    assert device.from_host(2, torch.int32, CPU) is first[2]
    assert device.from_host(1, torch.int32, CPU) is not first[1]
    assert device.uploads == {"hits": 2, "misses": 1}
    assert len(device._kept) == 3


def test_values_seen_once_never_push_out_those_used_again(cold, monkeypatch):
    """As in an authentication: each call uses the same few constants and a
    request adds words seen once; the constants stay, the words evict each
    other."""
    monkeypatch.setattr(device, "KEPT_ENTRIES", 4)
    shifts = [device.from_host([30 - 2 * j, j], torch.int64, CPU) for j in range(3)]
    device.reset_uploads()
    for nonce in range(100):
        device.from_host(np.array([nonce, 1, 0], np.int32), torch.int32, CPU)
        assert all(device.from_host([30 - 2 * j, j], torch.int64, CPU) is shifts[j]
                   for j in range(3))
    assert device.uploads == {"hits": 300, "misses": 100}
    assert len(device._kept) == 4


def test_a_kept_tensor_written_in_place_is_refused(cold):
    kept = device.from_host([1, 2], torch.int32, CPU)
    kept.add_(1)
    with pytest.raises(RuntimeError, match="written in place"):
        device.from_host([1, 2], torch.int32, CPU)


@pytest.mark.parametrize("kind", ["level", "gate", "mux"])
def test_a_warmed_backend_makes_no_upload(cold, system, kind):
    _, ck, (x, y, z) = system
    call = _calls(CipherBackend(ck), x, y, z)[kind]
    first = _bits(call())
    assert device.uploads["misses"] > 0
    device.reset_uploads()
    again = _bits(call())
    assert device.uploads["misses"] == 0 and device.uploads["hits"] > 0
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_no_caller_writes_a_kept_tensor(cold, system):
    _, ck, (x, y, z) = system
    be = CipherBackend(ck)
    for call in _calls(be, x, y, z).values():
        call()
    be.CONSTANT(np.array([1, 0, 1, 1], np.int32), (4,))
    kept = _kept()
    versions = [t._version for t in kept]
    clones = [t.clone() for t in kept]
    for call in _calls(be, x, y, z).values():
        call()
    a_ext, b_ext = bs.bootstrap_wo_ks(ck, x, gates.MU_1_8)
    bs.keyswitch(ck, a_ext, b_ext)
    be.CONSTANT(np.array([1, 0, 1, 1], np.int32), (4,))
    assert [t._version for t in kept] == versions
    assert all(torch.equal(t, c) for t, c in zip(kept, clones))


@pytest.mark.parametrize("value", [0, 1])
def test_a_python_constant_equals_the_array_constant(system, value):
    _, ck, _ = system
    by_int = gates.CONSTANT(ck, value, (2, 3))
    by_array = gates.CONSTANT(ck, np.full((2, 3), value, np.int32), (2, 3))
    assert torch.equal(by_int.a, by_array.a) and torch.equal(by_int.b, by_array.b)
    assert by_int.b.dtype == torch.int32 and by_int.b.is_contiguous()


def test_python_weights_equal_tensor_weights(system):
    """A lone gate's int weights, kept on the device, act on the int32 ops as
    int32 tensors do, wrap-around included (XOR's 2 * a and MU_1_4 overflow
    int32)."""
    _, ck, (x, _, z) = system
    ints = gates.lincomb_bootstrap(ck, x, z, 2, 2, gates.MU_1_4)
    i32 = [torch.tensor(w, dtype=torch.int32) for w in (2, 2, gates.MU_1_4)]
    tensors = gates.lincomb_bootstrap(ck, x, z, *i32)
    assert torch.equal(ints.a, tensors.a) and torch.equal(ints.b, tensors.b)
