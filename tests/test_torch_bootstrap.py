"""Gate bootstrap of the port, bit-equal to peba1_tpu's with carried keys.

The JAX package makes the keys and the input ciphertexts; the port gets the
same tensors through keys.cloud_key_from_numpy (JAX's bk_w included).  The
reference runs in its plain configuration (no Pallas kernel), as
tests/test_fused.py does; the port runs the path its parameters select, each
kernel's wrapper running its plain twin on the CPU.  Cases that share their
cryptographic parameters (they differ only in kernel flags) share one JAX
keygen and one reference bootstrap.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import gates as jgates
from peba1_tpu import keys as jkeys
from peba1_tpu import lwe as jlwe
from peba1_tpu.ops import bootstrap as jbs
from peba1_tpu.ops import poly as jpoly
from peba1_tpu.params import TOY, TOY_FAST, TOY_NOISY, TOY_T2
from peba1_tpu_torch import gates, keys, lwe
from peba1_tpu_torch.ops import bootstrap as bs
from peba1_tpu_torch.ops import cuda_kernels

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

CASES = {
    "toy": TOY,
    "toy_t2_gen": dataclasses.replace(TOY_T2, use_gen_step=True),
    "toy_n256_gen": dataclasses.replace(TOY, N=256, use_gen_step=True),
    "toy_fast": TOY_FAST,
    "toy_t2": TOY_T2,
    "toy_t2_stream": dataclasses.replace(TOY_T2, w_streaming=True),
    "toy_fast_genf": dataclasses.replace(TOY_FAST, use_gen_step=True, use_gen_full=True),
    "toy_t2_extprod": dataclasses.replace(TOY_T2, use_fused_step=False,
                                          use_pallas_extprod=True),
    "toy_fused": dataclasses.replace(TOY, use_fused_cmux=True),
    "toy_fast_fused": dataclasses.replace(TOY_FAST, use_fused_cmux=True),
    "toy_t2_fused": dataclasses.replace(TOY_T2, use_fused_cmux=True),
    "toy_amat": dataclasses.replace(TOY, ext_backend="amat"),
    "toy_conv": dataclasses.replace(TOY, ext_backend="conv"),
}
# case -> the kernel wrappers its blind rotation enters
WRAPPERS = {"toy": set(), "toy_t2_gen": {"cmux_step_gen"},
            "toy_n256_gen": {"cmux_step_gen"}, "toy_fast": {"rotate_decompose"},
            "toy_t2": {"cmux_step"}, "toy_t2_stream": {"cmux_step"},
            "toy_fast_genf": {"blind_rotate_gen_full"},
            "toy_t2_extprod": {"rotate_decompose", "extprod_recombine"},
            "toy_fused": {"fused_blind_rotate"}, "toy_fast_fused": {"fused_blind_rotate"},
            "toy_t2_fused": {"fused_blind_rotate"}, "toy_amat": set(), "toy_conv": set()}
# case family (the name before "_gen", "_stream", ...) -> the parameters its
# JAX keygen runs under; TOY_T2 builds bk_w.
FAMILIES = {"toy": TOY, "toy_t2": TOY_T2, "toy_n256": dataclasses.replace(TOY, N=256),
            "toy_fast": TOY_FAST}


def family_of(case_name):
    return max((f for f in FAMILIES if case_name.startswith(f)), key=len)


def _plain(base):
    return dataclasses.replace(
        base, use_fused_cmux=False, use_pallas_rotate=False,
        use_pallas_extprod=False, use_fused_step=False, use_gen_step=False,
        use_gen_full=False, w_streaming=False)


def carry(p, ck):
    """The JAX keyset's tensors into the port: bk_w and the A-matrix in
    JAX's layouts (the A-matrix built by peba1_tpu's prepare_amat), bk_conv
    as it is."""
    bk_w = None if ck.bk_w is None else np.array(ck.bk_w)
    bk_amat = (np.array(jax.jit(jpoly.prepare_amat, static_argnames="block")(
        ck.bk_tp, block=p.amat_block)) if keys.need_amat(p) else None)
    return keys.cloud_key_from_numpy(p, np.array(ck.bk_tp), np.array(ck.ks_table_limbs),
                                     "cpu", bk_w=bk_w, bk_amat=bk_amat,
                                     bk_conv=np.array(ck.bk_conv))


@functools.lru_cache(maxsize=None)
def family(name):
    """One JAX keygen, a batch of 37 ciphertexts ready for the identity
    bootstrap AND(x, x) in both packages' types, and the plain reference's
    bootstrap and bootstrap_wo_ks of them."""
    p = FAMILIES[name]
    sk, ck = jkeys.keygen(jax.random.PRNGKey(0), p)
    bits = jnp.arange(37) % 3 % 2
    ct = jgates.encrypt_bits(jax.random.PRNGKey(1), sk, bits)
    pre = jlwe.Lwe(ct.a * 2, ct.b * 2 + jnp.int32(-jgates.MU_1_8))
    tpre = lwe.Lwe(torch.as_tensor(np.array(pre.a)), torch.as_tensor(np.array(pre.b)))
    plain = ck.replace(params=_plain(p))
    ref = jbs.bootstrap(plain, pre, jnp.int32(jgates.MU_1_8))
    ref_wo_ks = jbs.bootstrap_wo_ks(plain, pre, jnp.int32(jgates.MU_1_8))
    return sk, ck, bits, tpre, ref, ref_wo_ks


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """A case's parameters, its family's JAX keyset and reference, the
    keyset carried into the port (read only by the tests), its wrappers."""
    sk, ck, bits, tpre, ref, ref_wo_ks = family(family_of(request.param))
    p = CASES[request.param]
    return p, sk, carry(p, ck), bits, tpre, ref, ref_wo_ks, WRAPPERS[request.param]


def test_bootstrap_bit_equal_to_reference(case):
    p, sk, tck, bits, tpre, ref, _, _ = case
    out = bs.bootstrap(tck, tpre, gates.MU_1_8)
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    tsk = keys.secret_key_from_numpy(p, np.array(sk.lwe_key), np.array(sk.tlwe_key), "cpu")
    np.testing.assert_array_equal(gates.decrypt_bits(out, tsk).numpy(), np.asarray(bits))


def test_bootstrap_wo_ks_bit_equal_to_reference(case):
    p, _, tck, _, tpre, _, (ra, rb), _ = case
    ta, tb = bs.bootstrap_wo_ks(tck, tpre, gates.MU_1_8)
    np.testing.assert_array_equal(np.asarray(ra), ta.numpy())
    np.testing.assert_array_equal(np.asarray(rb), tb.numpy())


def test_blind_rotate_enters_its_wrappers(case, monkeypatch):
    """Each configuration goes through the wrappers of the TPU kernels its
    JAX branch calls (the plain twins run inside them on the CPU), reading
    only the key form keys.active_bk_field names (the others are dropped by
    keys.slim_for_bootstrap)."""
    p, _, tck, _, tpre, _, _, wrappers = case
    entered = set()
    for name in cuda_kernels.launches:
        def spy(*args, _name=name, _fn=getattr(cuda_kernels, name)):
            entered.add(_name)
            return _fn(*args)
        monkeypatch.setattr(cuda_kernels, name, spy)
    assert (tck.bk_w is not None) == keys.need_w(p)
    assert (tck.bk_amat is not None) == keys.need_amat(p)
    slim = keys.slim_for_bootstrap(tck)
    assert [f for f in ("bk", "bk_conv", "bk_tp", "bk_amat", "bk_w")
            if getattr(slim, f) is not None] == [keys.active_bk_field(p)]
    bs.bootstrap_wo_ks(slim, lwe.Lwe(tpre.a[:3], tpre.b[:3]), gates.MU_1_8)
    assert entered == wrappers
    assert (bs.selected_kernel(p) in wrappers) == (bs.selected_kernel(p) is not None)


@pytest.fixture(scope="module")
def noisy_keys():
    return keys.keygen(torch.Generator().manual_seed(5), TOY_NOISY, "cpu")


def _phase_err(ct, sk, bits):
    ph = lwe.phase(ct, sk.lwe_key).numpy().astype(np.int64)
    want = np.where(np.asarray(bits) != 0, 2**29, -(2**29))
    d = (ph - want) % (1 << 32)
    return np.minimum(d, (1 << 32) - d)


def test_fresh_encryption_noise_of_port_keygen(noisy_keys):
    """Noise statistics, the one place with a tolerance: the largest error
    of 256 fresh samples stays under 6 sigma, and the spread is real noise
    (sample std above 0.3 sigma), as tests/test_noise.py holds the JAX
    package to."""
    sk, _ = noisy_keys
    bits = np.arange(256) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(6), sk, bits)
    err = _phase_err(ct, sk, bits)
    sigma = TOY_NOISY.lwe_stdev * 2**32
    assert err.max() < 6 * sigma
    assert err.std() > 0.3 * sigma


def test_bootstrap_noise_of_port_keygen(noisy_keys):
    """After one bootstrap the phase error stays below 1/16 of the torus
    (2^28) and every bit decodes."""
    sk, ck = noisy_keys
    bits = np.arange(128) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(7), sk, bits)
    out = bs.bootstrap(ck, ct, gates.MU_1_8)
    assert _phase_err(out, sk, bits).max() < 2**28
    np.testing.assert_array_equal(gates.decrypt_bits(out, sk).numpy(), bits)


def test_port_keygen_decrypts_through_the_gen_path():
    p = CASES["toy_t2_gen"]
    sk, ck = keys.keygen(torch.Generator().manual_seed(8), p, "cpu")
    bits = np.arange(19) % 2
    ct = gates.encrypt_bits(torch.Generator().manual_seed(9), sk, bits)
    out = gates.AND(ck, ct, ct)
    np.testing.assert_array_equal(gates.decrypt_bits(out, sk).numpy(), bits)
    assert tuple(ck.bk_tp.shape) == (p.n, 6, 11, 2 * p.N)
    assert tuple(ck.ks_table_limbs.shape) == (p.big_n * p.ks_t, (p.n + 1) * 4)
