"""Tests of the port that need the card (marker `cuda`; they skip elsewhere).

This file imports neither jax nor peba1_tpu, so it also runs where only the
port is installed.  On the card, without the jax-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import cell_params
from peba1_tpu_torch import gates, keys, lwe
from peba1_tpu_torch.backends import CipherBackend
from peba1_tpu_torch.ops import bootstrap as bs
from peba1_tpu_torch.ops import cuda_kernels as ck
from peba1_tpu_torch.ops import poly
from peba1_tpu_torch.params import PRESETS, TOY, TOY_FAST, TOY_T2
from peba1_tpu_torch.utils import device as dev


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda", 0)


def random_step_inputs(p, B, steps, seed, device):
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    rng = np.random.default_rng(seed)
    acc = rng.integers(-2**31, 2**31, (B, (p.k + 1) * p.N), dtype=np.int64)
    acc[0, :4] = [-2**31, 2**31 - 1, 0, -1]
    amt = rng.integers(0, 2 * p.N, (steps, B)).astype(np.int32)
    vv = rng.integers(-128, 128, (steps, G, C, 2 * p.N)).astype(np.int8)
    vv[:, 0, 0, :] = -128
    return (torch.as_tensor(acc.astype(np.int32), device=device),
            torch.as_tensor(amt, device=device), torch.as_tensor(vv, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("peba1_128_t2_gen", 1000), ("peba1_128_fast_gen", 64),
                                    ("ring_2048_gen", 67)])
def test_kernel_matches_plain(cuda_device, name, B):
    p = PRESETS[name]
    acc, amt, vv = random_step_inputs(p, B, 2, 4, cuda_device)
    want = ck.cmux_step_gen_plain(acc.clone(), amt, vv, p)
    before = ck.launches["cmux_step_gen"]
    got = ck.cmux_step_gen(acc.clone(), amt, vv, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["cmux_step_gen"] == before + 1       # both steps, one launch


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,steps", [
    ("peba1_128_fast_genf", 1000, 3), ("peba1_128_t2_genf", 67, 2)])
def test_blind_rotate_gen_full_matches_plain(cuda_device, name, B, steps):
    """One launch for the whole rotation; a batch above one 64-row tile, so
    a missing grid barrier would show."""
    p = PRESETS[name]
    _, amt, vv = random_step_inputs(p, B, steps + 1, 5, cuda_device)
    vv = vv[:steps].contiguous()
    mu = -(1 << 29) + 7
    want = ck.blind_rotate_gen_full_plain(amt, vv, mu, p)
    before = ck.launches["blind_rotate_gen_full"]
    got = ck.blind_rotate_gen_full(amt, vv, mu, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["blind_rotate_gen_full"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rotate_decompose", "extprod_recombine", "cmux_step"])
@pytest.mark.parametrize("name,B", [("peba1_128_t2", 1000), ("peba1_128_fast", 67)])
def test_w_kernels_match_plain(cuda_device, kernel, name, B):
    """The precomputed-weight family on random acc, amt and W (the port's
    (C*N, G*N) layout): every output polynomial, o < k and o = k; cmux_step
    runs both steps in one launch."""
    p = PRESETS[name]
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    acc, amt, _ = random_step_inputs(p, B, 2, 6, cuda_device)
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.integers(-128, 128, (2, C * p.N, G * p.N)).astype(np.int8),
                        device=cuda_device)
    d = torch.as_tensor(rng.integers(-p.half_bg, p.half_bg, (B, G * p.N)).astype(np.int8),
                        device=cuda_device)
    args = {"rotate_decompose": (acc, amt[0]), "extprod_recombine": (d, w[0]),
            "cmux_step": (acc, amt, w)}[kernel]
    want = getattr(ck, kernel + "_plain")(*[a.clone() for a in args], p)
    before = ck.launches[kernel]
    got = getattr(ck, kernel)(*[a.clone() for a in args], p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches[kernel] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 67, 1000, 8192])
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast", "tfhers_bool_gen"])
def test_rotate_decompose_at_its_batches(cuda_device, name, B):
    """Kernel 3 against its plain twin, one launch: a lone row, fewer rows
    than blocks, and 8,192 rows, where each block's rows outnumber its ring
    of stages; the first rows rotate by 0, N and 2N - 1.  tfhers_bool_gen's
    gadget (l = 3 digits of 6 bits) runs the kernel's run-time instance."""
    p = PRESETS[name]
    acc, amt, _ = random_step_inputs(p, B, 1, 18, cuda_device)
    amt = amt[0]
    amt[:3] = torch.tensor([0, p.N, 2 * p.N - 1][:B])
    plan = ck.rotdec_plan(B, p, ck._sm_count(cuda_device))
    assert (B > plan.blocks * plan.stages) == (B == 8192)
    want = ck.rotate_decompose_plain(acc, amt, p)
    before = ck.launches["rotate_decompose"]
    got = ck.rotate_decompose(acc, amt, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["rotate_decompose"] == before + 1


@pytest.mark.cuda
def test_rotate_decompose_refuses_an_unaligned_acc(cuda_device):
    """A contiguous view 4 bytes past a 16-byte boundary: the bulk copy
    cannot take it, and nothing computes the digits another way."""
    p = PRESETS["peba1_128_t2"]
    cols = (p.k + 1) * p.N
    acc = torch.zeros(4 * cols + 1, dtype=torch.int32, device=cuda_device)[1:].view(4, cols)
    amt = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    assert acc.is_contiguous() and acc.data_ptr() % 16
    before = ck.launches["rotate_decompose"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.rotate_decompose(acc, amt, p)
    assert ck.launches["rotate_decompose"] == before


FUSED = {"fast": dataclasses.replace(PRESETS["peba1_128_fast"], use_fused_cmux=True),
         "fast_k256": dataclasses.replace(PRESETS["peba1_128_fast"], use_fused_cmux=True,
                                          amat_block=256),
         "t2": dataclasses.replace(PRESETS["peba1_128_t2"], use_fused_step=False,
                                   use_fused_cmux=True)}


def random_amat(p, steps, seed, device):
    """Random bytes in the A-matrix's shape (n, C, G, span, K)."""
    K, _, span = poly.amat_geometry(p.N, p.amat_block)
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, (steps, C, G, span, K), generator=gen,
                         dtype=torch.int8, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,steps", [("fast", 1000, 3), ("fast_k256", 1000, 2),
                                          ("t2", 67, 2)])
def test_fused_blind_rotate_matches_plain(cuda_device, name, B, steps):
    """One launch for the whole rotation, at U = 8 (K=128), U = 4 (K=256)
    and k = 2; B=1000 is above one 64-row tile, so a missing grid barrier
    would show."""
    p = FUSED[name]
    _, amt, _ = random_step_inputs(p, B, steps + 1, 8, cuda_device)
    amat = random_amat(p, steps, 9, cuda_device)
    mu = -(1 << 29) + 7
    want = ck.fused_blind_rotate_plain(amt, amat, mu, p)
    before = ck.launches["fused_blind_rotate"]
    got = ck.fused_blind_rotate(amt, amat, mu, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["fused_blind_rotate"] == before + 1


# The kernels on csrc/whole_rotation.cuh that run CMUX steps: the two whole
# rotations, and cmux_step_gen's and cmux_step's steps on an incoming
# accumulator.
ROTATIONS = {"fast_genf": ("blind_rotate_gen_full", PRESETS["peba1_128_fast_genf"]),
             "t2_genf": ("blind_rotate_gen_full", PRESETS["peba1_128_t2_genf"]),
             "fast_fused": ("fused_blind_rotate", FUSED["fast"]),
             "fast_fused_k256": ("fused_blind_rotate", FUSED["fast_k256"]),
             "t2_fused": ("fused_blind_rotate", FUSED["t2"]),
             "t2_gen": ("cmux_step_gen", PRESETS["peba1_128_t2_gen"]),
             "fast_gen": ("cmux_step_gen", PRESETS["peba1_128_fast_gen"]),
             "ring_2048_gen": ("cmux_step_gen", PRESETS["ring_2048_gen"]),
             "tfhers_gen": ("cmux_step_gen", PRESETS["tfhers_bool_gen"]),
             "t2_w": ("cmux_step", PRESETS["peba1_128_t2"]),
             "fast_w": ("cmux_step", PRESETS["peba1_128_fast_stream"])}


def random_w(p, steps, seed, device):
    """Random bytes in bk_w's shape (n, C*N, G*N)."""
    G, C = (p.k + 1) * p.l, sum(p.limb_plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, (steps, C * p.N, G * p.N), generator=gen,
                         dtype=torch.int8, device=device)


def rotation_inputs(name, B, steps, device):
    """(kernel, params, the kernel's arguments before the params)."""
    kernel, p = ROTATIONS[name]
    acc, amt, vv = random_step_inputs(p, B, steps + 1, 13, device)
    if kernel == "cmux_step_gen":
        return kernel, p, (acc, amt[1:].contiguous(), vv[:steps].contiguous())
    if kernel == "cmux_step":
        return kernel, p, (acc, amt[1:].contiguous(), random_w(p, steps, 15, device))
    key = random_amat(p, steps, 14, device) if kernel == "fused_blind_rotate" \
        else vv[:steps].contiguous()
    return kernel, p, (amt, key, -(1 << 29) + 7)


def call(fn, args, p):
    """fn on copies of the tensor arguments (the step kernels update acc in place)."""
    return fn(*[a.clone() if isinstance(a, torch.Tensor) else a for a in args], p)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 67, 184, 760])
@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rotation_kernels_at_protocol_batches(cuda_device, name, B):
    """The kernels on the whole-rotation skeleton at the batches whose tile
    plan splits the contraction most (B=1, 67, 184) and at the sweep's rows
    (760, a ragged last row tile), each against its plain twin."""
    kernel, p, args = rotation_inputs(name, B, 2, cuda_device)
    want = call(getattr(ck, kernel + "_plain"), args, p)
    before = ck.launches[kernel]
    got = call(getattr(ck, kernel), args, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches[kernel] == before + 1


def largest_split(monkeypatch):
    """Make tile_plan put every block of the contraction in its own split."""
    plan = ck.tile_plan

    def largest(*args, **kw):
        got = plan(*args, **kw)
        return dataclasses.replace(got, split=got.blocks)

    monkeypatch.setattr(ck, "tile_plan", largest)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(n for n, (kernel, _) in ROTATIONS.items()
                                        if kernel not in ck.BY_STAGE))
def test_rotation_kernels_at_the_largest_split(cuda_device, name, monkeypatch):
    """Every block of the contraction its own work item, at a batch whose
    plan would not split (B=1000 needs 2): the atomic adds of all splits
    still give the plain twin's bits.  Kernels 1 and 2 take no split."""
    kernel, p, inputs = rotation_inputs(name, 1000, 2, cuda_device)
    largest_split(monkeypatch)
    want = call(getattr(ck, kernel + "_plain"), inputs, p)
    got = call(getattr(ck, kernel), inputs, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def extprod_inputs(name, B, device):
    """Digits in the gadget's range and one random step of bk_w."""
    p = PRESETS[name]
    G = (p.k + 1) * p.l
    rng = np.random.default_rng(16)
    d = torch.as_tensor(rng.integers(-p.half_bg, p.half_bg, (B, G * p.N)).astype(np.int8),
                        device=device)
    return p, d, random_w(p, 1, 17, device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 67, 184, 1000, 2048])
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast"])
def test_extprod_recombine_at_protocol_batches(cuda_device, name, B):
    """Kernel 5 against its plain twin, one launch: the batches whose plan
    splits the contraction (adds into zeros) and those that store."""
    p, d, w = extprod_inputs(name, B, cuda_device)
    want = ck.extprod_recombine_plain(d, w, p)
    before = ck.launches["extprod_recombine"]
    got = ck.extprod_recombine(d, w, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches["extprod_recombine"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast"])
def test_extprod_recombine_at_the_largest_split(cuda_device, name, monkeypatch):
    """Every digit polynomial its own split at 2,048 rows, which the plan
    would not split: the adds into the zeroed output give the twin's bits."""
    p, d, w = extprod_inputs(name, 2048, cuda_device)
    largest_split(monkeypatch)
    want = ck.extprod_recombine_plain(d, w, p)
    got = ck.extprod_recombine(d, w, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["peba1_128_t2", "peba1_128_fast", "peba1_128_t2_genf"])
def test_fused_path_runs(cuda_device, name):
    """use_fused_cmux, which no preset sets, on any preset: blind_rotate
    takes the fused branch first, with one kernel launch over all n steps,
    equal to the plain twin."""
    p = dataclasses.replace(PRESETS[name], use_fused_cmux=True)
    stand_in = _AmatKey(p, random_amat(p, p.n, 10, cuda_device))
    rng = np.random.default_rng(11)
    bara = torch.as_tensor(rng.integers(0, 2 * p.N, (3, p.n), dtype=np.int32),
                           device=cuda_device)
    barb = torch.as_tensor(rng.integers(0, 2 * p.N, 3, dtype=np.int32), device=cuda_device)
    before = dict(ck.launches)
    got = bs.blind_rotate(stand_in, bara, barb, 12345)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ck.launches.items() if v != before[k]} == {
        "fused_blind_rotate": 1}
    amt = torch.cat([((2 * p.N - barb) % (2 * p.N))[None], bara.T]).to(torch.int32)
    want = ck.fused_blind_rotate_plain(amt, stand_in.bk_amat, 12345, p)
    assert torch.equal(got.reshape(3, -1), want)


class _AmatKey:
    """A stand-in cloud key: the fused branch reads only the A-matrix."""

    def __init__(self, params, bk_amat):
        self.params = params
        self.bk_amat = bk_amat


@pytest.mark.cuda
@pytest.mark.parametrize("p", [
    dataclasses.replace(TOY_T2, use_gen_step=True),
    dataclasses.replace(TOY, N=256, use_gen_step=True),
    TOY_FAST, TOY_T2, dataclasses.replace(TOY_T2, w_streaming=True),
    dataclasses.replace(TOY_FAST, use_gen_step=True, use_gen_full=True),
    dataclasses.replace(TOY_T2, use_fused_step=False, use_pallas_extprod=True),
    dataclasses.replace(TOY_FAST, use_fused_cmux=True),
    dataclasses.replace(TOY_T2, use_fused_cmux=True),
    dataclasses.replace(TOY_FAST, N=256, use_fused_cmux=True)],
    ids=["toy_t2_gen", "toy_n256_gen", "toy_fast", "toy_t2", "toy_t2_stream",
         "toy_fast_genf", "toy_t2_extprod", "toy_fast_fused", "toy_t2_fused",
         "toy_fast_n256_fused"])
def test_bootstrap_on_the_card_equals_the_cpu(cuda_device, p):
    """The same key and ciphertext tensors: the kernel path on the card and
    the plain path on the CPU give the same bits."""
    sk, cpu_key = keys.keygen(torch.Generator().manual_seed(1), p, "cpu")
    gpu_key = dataclasses.replace(cpu_key, **{
        f.name: getattr(cpu_key, f.name).to(cuda_device)
        for f in dataclasses.fields(cpu_key)
        if isinstance(getattr(cpu_key, f.name), torch.Tensor)})
    bits = np.arange(77) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(2), sk, bits)
    pre = lwe.Lwe(ct.a * 2, ct.b * 2 - gates.MU_1_8)
    want = bs.bootstrap(cpu_key, pre, gates.MU_1_8)
    got = bs.bootstrap(gpu_key, lwe.Lwe(pre.a.to(cuda_device), pre.b.to(cuda_device)),
                       gates.MU_1_8)
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)
    np.testing.assert_array_equal(gates.decrypt_bits(want, sk).numpy(), bits)


def key_on(cpu_key, device):
    return dataclasses.replace(cpu_key, **{
        f.name: getattr(cpu_key, f.name).to(device)
        for f in dataclasses.fields(cpu_key)
        if isinstance(getattr(cpu_key, f.name), torch.Tensor)})


def sleep_cycles(ms: float) -> int:
    """GPU clock cycles of `torch.cuda._sleep` that take about `ms`."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return int(10**7 * ms / start.elapsed_time(end))


@pytest.mark.cuda
def test_the_host_runs_ahead_of_the_card(cuda_device):
    """On a warmed backend a level, a lone gate, a MUX and a CONSTANT of
    values never seen before never wait for the stream: queued behind about
    50 ms of device sleep, they all return while an event recorded after the
    sleep is still pending.  Then their bits equal the plain path's."""
    p = dataclasses.replace(TOY_FAST, use_gen_step=True, use_gen_full=True)
    sk, cpu_key = keys.keygen(torch.Generator().manual_seed(1), p, "cpu")
    g = torch.Generator().manual_seed(2)
    cts = [gates.encrypt_bits(g, sk, np.arange(92) % m < m // 2) for m in (2, 3, 5)]

    def calls(be, xyz, word):
        x, y, z = xyz
        return [*be.level([("AND", x, y), ("XOR", y, z), ("ORYN", x, z)]),
                be.gate("NAND", x, z), be.MUX(x, y, z), be.CONSTANT(word, word.shape)]

    be = CipherBackend(key_on(cpu_key, cuda_device))
    on_card = [lwe.Lwe(c.a.to(cuda_device), c.b.to(cuda_device)) for c in cts]
    calls(be, on_card, np.array([1, 0, 1], np.int32))            # warm
    cycles = sleep_cycles(50)
    torch.cuda.synchronize()
    dev.reset_uploads()
    word = np.array([0, 1, 1, 0, 1], np.int32)                   # a miss
    torch.cuda._sleep(cycles)
    slept = torch.cuda.Event()
    slept.record()
    got = calls(be, on_card, word)
    pending = not slept.query()
    torch.cuda.synchronize()
    assert pending
    assert dev.uploads["misses"] == 1 and dev.uploads["hits"] > 0
    want = calls(CipherBackend(cpu_key), cts, word)
    assert all(torch.equal(a.a.cpu(), b.a) and torch.equal(a.b.cpu(), b.b)
               for a, b in zip(got, want))


@pytest.mark.cuda
def test_bench_on_the_card(cuda_device):
    """The port's headline benchmark runs on the card at toy_t2 (kernel 4,
    cmux_step) and decrypts every chained bit."""
    from peba1_tpu_torch import bench
    before = ck.launches["cmux_step"]
    rec = bench.main(["--params", "toy_t2", "--batch", "256", "--s1", "1", "--s2", "2",
                      "--reps", "1", "--device", "cuda"])
    assert rec["batch_correct_frac"] == 1.0 and rec["value"] > 0
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["power_limit"]
    assert ck.launches["cmux_step"] - before == 6        # 1 + 2 warm-up, 1 + 2 timed


@pytest.mark.cuda
def test_dryrun_shares_the_card(cuda_device):
    """The multi-rank dry run with two gloo ranks on one card at toy_t2:
    every check passes and each rank launches kernel 4 (cmux_step)."""
    from peba1_tpu_torch import dryrun
    rec = dryrun.main(["--world", "2", "--share-card", "--params", "toy_t2"])
    assert rec["backend"] == "gloo" and rec["mesh"] == [1, 2]
    assert rec["checks"] == ["sharded_bootstrap", "ringtp_k1", "ringtp_k2", "gspmd_identify",
                             "gspmd_identify_argmin"]
    for rank in rec["launches"]:
        for check in ("sharded_bootstrap", "gspmd_identify", "gspmd_identify_argmin"):
            assert rank[check].get("cmux_step", 0) > 0, rec["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,steps", [(184, 722), (8192, 8)])
def test_kernel_1_at_the_tfhers_bool_lattice(cuda_device, B, steps):
    """Kernel 1 at tfhers_bool_gen (G = 9 digit polynomials of 6-bit
    digits, C = 12 limbs) against its plain twin: every one of the 722
    steps of a bootstrap call at an authentication's rows, where a step's
    48 items of 36 stages are spread over the grid by stage, and 8 steps at
    8,192 rows; both unsplit, one launch."""
    p = PRESETS["tfhers_bool_gen"]
    assert ck.tile_plan(B, p, "cmux_step_gen", ck._sm_count(cuda_device)).split == 1
    acc, amt, vv = random_step_inputs(p, B, steps, 19, cuda_device)
    want = ck.cmux_step_gen_plain(acc.clone(), amt, vv, p)
    before = ck.launches["cmux_step_gen"]
    got = ck.cmux_step_gen(acc.clone(), amt, vv, p)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0
    assert ck.launches["cmux_step_gen"] == before + 1


# Kernels 1 and 2 at the benchmark cells' lattices and at the default t2_gen;
# kernel 2 at TOY (N = 128: a digit polynomial is one stage).
WALKED = {"tfhe128_genf": ("blind_rotate_gen_full", cell_params()["peba1_tfhe128_genf"]),
          "tfhers_gen": ("cmux_step_gen", PRESETS["tfhers_bool_gen"]),
          "t2_gen": ("cmux_step_gen", PRESETS["peba1_128_t2_gen"]),
          "toy_genf": ("blind_rotate_gen_full", TOY)}
WALK_CASES = ([(name, B) for name in ("t2_gen", "tfhe128_genf", "tfhers_gen")
               for B in (1, 92, 128, 256, 512, 1152, 8192)]
              + [("toy_genf", 1), ("toy_genf", 8192)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", WALK_CASES)
def test_the_walk_by_stage_matches_plain(cuda_device, name, B):
    """Kernels 1 and 2 walk each step's last partial wave of work items by
    stage: three steps against the plain twin at an authentication's call
    sizes and at 8,192 rows, one launch.  Their producer expands its first
    unit's first stages inside barrier 1 (at most three, one below 128
    rows): at one row at TOY most blocks' walk is empty and the others
    expand one stage; at 128 rows at tfhe128_genf some blocks' first unit
    is shorter than three stages, and at 8,192 rows at TOY every block's;
    at 8,192 rows at tfhe128_genf every block expands three
    (tests/test_torch_splitk.py's test_the_card_cases_of_the_early_stages)."""
    kernel, p = WALKED[name]
    steps = 3
    acc, amt, vv = random_step_inputs(p, B, steps + 1, 20, cuda_device)
    vv = vv[:steps].contiguous()
    args = ((acc, amt[1:].contiguous(), vv) if kernel == "cmux_step_gen"
            else (amt, vv, -(1 << 29) + 7))
    want = call(getattr(ck, kernel + "_plain"), args, p)
    before = ck.launches[kernel]
    got = call(getattr(ck, kernel), args, p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ck.launches[kernel] == before + 1
