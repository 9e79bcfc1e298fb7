"""The port's parallel layer against peba1_tpu, on a gloo world of 4 CPU ranks.

One world is spawned once for the module (this file run as a script, one
process per rank, a ``file://`` store in a temporary directory).  Every rank
builds the ('dp', 'tp') meshes 2x2, 1x4 and 4x1, runs every sharded function
of ``peba1_tpu_torch.parallel.shard`` on the same JAX-made TOY keys and
ciphertexts, and writes what it returns; the parametrised tests below hold
each rank's result bit for bit to the JAX package's single-device function
on the same inputs (JAX's own tests prove its sharded forms equal to those).
The column functions of ``ops/poly`` are compared with JAX's directly, and
the ValueErrors the JAX functions raise are checked on the ranks' meshes.

Only torch, numpy and the port are imported at module level, so that the
ranks import no jax.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
BITSIZE = 2                              # the identify cases' slot width
PROTO = dict(nslots=2, bitsize=BITSIZE, max_bitsize=3 * BITSIZE,
             mul_width=3 * BITSIZE - 1, bound_match=0)
# sharded case (function, mesh) -> the number of ciphertexts it returns
CASES = {
    "bootstrap_2x2": 1, "bootstrap_dp_4x1": 1,
    "ringtp_1x4_k1": 1, "ringtp_1x4_k2": 1, "ringtp_2x2_k2": 1,
    "tree_sum_2x2": 1, "tree_sum_1x4": 1,
    "argmin_2x2": 2, "argmin_4x1": 2,
    "gspmd_identify_2x2": 1, "gspmd_identify_argmin_2x2": 2,
    "gspmd_identify_argmin_6_2x2": 2, "gspmd_identify_argmin_12_4x1": 2,
    "identify_4x1": 1, "identify_2x2": 1, "identify_argmin_4x1": 2,
    "euclidean_2x2": 1,
}
ERRORS = {
    "overlap_blocks_3": "overlap_blocks=3 must divide",
    "overlap_blocks_0": "overlap_blocks=0 must divide",
    "identify_3_templates": "n_templates=3 not divisible by dp=2",
    "identify_argmin_3_templates": "n_templates=3 not divisible by dp=2",
    "tree_sum_3_slots_a_shard": "needs power-of-two slots per shard",
    "euclidean_6_slots_tp4": "nslots=6 not divisible by tp=4",
    "mesh_3x1": "a 3x1 mesh needs 3 ranks",
}


def _rank_main(rank: int, data: str) -> None:
    """One rank of the world: every sharded case, written to rank<r>.npz."""
    import torch.distributed as dist

    from peba1_tpu_torch import gates, keys, lwe
    from peba1_tpu_torch.parallel import mesh as pmesh
    from peba1_tpu_torch.parallel import shard as pshard
    from peba1_tpu_torch.params import TOY, ProtocolParams
    from peba1_tpu_torch.protocol import Server

    device = pmesh.init_distributed(f"file://{data}/store", WORLD, rank, device="cpu")
    x = np.load(os.path.join(data, "inputs.npz"))
    ck = keys.cloud_key_from_numpy(TOY, x["bk_tp"], x["ks"], "cpu")
    server = Server(ck, ProtocolParams(**PROTO))
    mu = gates.MU_1_8

    def ct(name):
        return lwe.Lwe(torch.as_tensor(x[name + ".a"]), torch.as_tensor(x[name + ".b"]))

    m = {s: pmesh.make_mesh(*map(int, s.split("x")), device=device) for s in ("2x2", "1x4", "4x1")}
    probe, tmpl, bound = ct("probe"), ct("tmpl"), ct("bound")
    tmpl12 = lwe.Lwe(torch.cat([tmpl.a, tmpl.a[:4]]), torch.cat([tmpl.b, tmpl.b[:4]]))
    runs = {
        "bootstrap_2x2": lambda: pshard.sharded_bootstrap(m["2x2"], ck, ct("boot"), mu),
        "bootstrap_dp_4x1": lambda: pshard.sharded_bootstrap(m["4x1"], ck, ct("boot_dp"), mu),
        "ringtp_1x4_k1": lambda: pshard.sharded_bootstrap_ringtp(m["1x4"], ck, ct("ring1"), mu),
        "ringtp_1x4_k2": lambda: pshard.sharded_bootstrap_ringtp(
            m["1x4"], ck, ct("ring2"), mu, overlap_blocks=2),
        "ringtp_2x2_k2": lambda: pshard.sharded_bootstrap_ringtp(
            m["2x2"], ck, ct("ring1"), mu, overlap_blocks=2),
        "tree_sum_2x2": lambda: pshard.sharded_tree_sum(m["2x2"], ck, ct("words"), 4),
        "tree_sum_1x4": lambda: pshard.sharded_tree_sum(m["1x4"], ck, ct("words"), 4),
        "argmin_2x2": lambda: pshard.sharded_argmin(m["2x2"], ck, ct("vals"), ct("idx")),
        "argmin_4x1": lambda: pshard.sharded_argmin(m["4x1"], ck, ct("vals"), ct("idx")),
        "gspmd_identify_2x2": lambda: pshard.gspmd_identify(m["2x2"], server, probe, tmpl,
                                                            bound),
        "gspmd_identify_argmin_2x2": lambda: pshard.gspmd_identify_argmin(
            m["2x2"], server, probe, tmpl),
        # Shards of 3 templates: argmin_tree's byes fall elsewhere than in a
        # tournament per shard, so only the whole-axis tree is bit-equal.
        "gspmd_identify_argmin_6_2x2": lambda: pshard.gspmd_identify_argmin(
            m["2x2"], server, probe, tmpl[:6]),
        "gspmd_identify_argmin_12_4x1": lambda: pshard.gspmd_identify_argmin(
            m["4x1"], server, probe, tmpl12),
        "identify_4x1": lambda: pshard.sharded_identify(m["4x1"], ck, probe, tmpl, bound,
                                                        BITSIZE),
        "identify_2x2": lambda: pshard.sharded_identify(m["2x2"], ck, probe, tmpl, bound,
                                                        BITSIZE),
        "identify_argmin_4x1": lambda: pshard.sharded_identify_argmin(
            m["4x1"], ck, probe, tmpl, BITSIZE, 3 * BITSIZE),
        "euclidean_2x2": lambda: pshard.sharded_euclidean(
            m["2x2"], ck, probe, tmpl, BITSIZE, 3 * BITSIZE),
    }
    out = {}
    for name, run in runs.items():
        res = run()
        for i, c in enumerate(res if isinstance(res, tuple) else (res,)):
            out[f"{name}.{i}.a"], out[f"{name}.{i}.b"] = c.a.numpy(), c.b.numpy()

    three = ct("tmpl")[:3]
    six = lwe.Lwe(torch.zeros((6, 4, TOY.n), dtype=torch.int32),
                  torch.zeros((6, 4), dtype=torch.int32))
    raising = {
        "overlap_blocks_3": lambda: pshard.sharded_bootstrap_ringtp(
            m["1x4"], ck, ct("ring1"), mu, overlap_blocks=3),
        "overlap_blocks_0": lambda: pshard.sharded_bootstrap_ringtp(
            m["1x4"], ck, ct("ring1"), mu, overlap_blocks=0),
        "identify_3_templates": lambda: pshard.sharded_identify(
            m["2x2"], ck, probe, three, bound, BITSIZE),
        "identify_argmin_3_templates": lambda: pshard.sharded_identify_argmin(
            m["2x2"], ck, probe, three, BITSIZE, 3 * BITSIZE),
        "tree_sum_3_slots_a_shard": lambda: pshard.sharded_tree_sum(m["2x2"], ck, six, 4),
        "euclidean_6_slots_tp4": lambda: pshard.sharded_euclidean(
            m["1x4"], ck, six, lwe.Lwe(six.a.expand(4, -1, -1, -1), six.b.expand(4, -1, -1)),
            BITSIZE, 3 * BITSIZE),
        "mesh_3x1": lambda: pmesh.make_mesh(3, 1, device=device),
    }
    for name, run in raising.items():
        try:
            run()
            out["error." + name] = np.array("")
        except ValueError as e:
            out["error." + name] = np.array(str(e))
    np.savez(os.path.join(data, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _jax_inputs(sk, ck):
    """The seeded inputs, as the JAX tests build them: (numpy arrays for the
    ranks, the JAX ciphertexts, the plaintext answers)."""
    import jax
    import jax.numpy as jnp

    from peba1_tpu import circuits as jcc
    from peba1_tpu import gates as jgates
    from peba1_tpu.backends import CipherBackend as JCipherBackend
    from peba1_tpu.utils.bits import int_to_bits

    inputs = {"bk_tp": np.asarray(ck.bk_tp), "ks": np.asarray(ck.ks_table_limbs)}
    cts = {}

    def enc(name, key, bits, nbits=None):
        bits = bits if nbits is None else int_to_bits(bits, nbits)
        cts[name] = jgates.encrypt_bits(key, sk, jnp.asarray(bits))

    enc("boot", jax.random.PRNGKey(3), np.arange(16) % 2)
    enc("boot_dp", jax.random.PRNGKey(4), np.ones(8, int))
    enc("ring1", jax.random.PRNGKey(6), np.arange(8) % 2)
    enc("ring2", jax.random.PRNGKey(7), (np.arange(8) + 1) % 2)
    words = np.random.default_rng(12).integers(0, 1 << 3, (2, 8))
    enc("words", jax.random.PRNGKey(8), words, 4)
    vals = np.random.default_rng(11).integers(0, 1 << 4, 8)
    vals[3] = vals[6] = vals.min()            # a tie: the lowest index must win
    enc("vals", jax.random.PRNGKey(5), vals, 4)
    cts["idx"] = jcc.const_word(JCipherBackend(ck), np.arange(8), 3, (8,))
    # Nonzero slots (a zero probe slot meets the reference's sub_abs quirk);
    # both verdicts, and an argmin tie between templates 1 and 5.
    tmpl = np.array([[1, 1], [2, 2], [3, 1], [1, 2], [3, 3], [2, 2], [1, 1], [3, 2]])
    probe = np.array([2, 2])
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    enc("probe", k1, probe, BITSIZE)
    enc("tmpl", k2, tmpl, BITSIZE)
    cts["bound"] = jcc.const_word(JCipherBackend(ck), 0, 3 * BITSIZE)
    for name, c in cts.items():
        inputs[name + ".a"], inputs[name + ".b"] = np.asarray(c.a), np.asarray(c.b)

    d = ((tmpl - probe) ** 2).sum(1)
    d12 = np.concatenate([d, d[:4]])
    plain = {"bootstrap_2x2": np.arange(16) % 2, "ringtp_1x4_k1": np.arange(8) % 2,
             "ringtp_1x4_k2": (np.arange(8) + 1) % 2, "tree_sum_2x2": words.sum(1) % 16,
             "argmin_2x2": int(np.argmin(vals)), "identify_4x1": (d > 0).astype(int),
             "identify_argmin_4x1": int(np.argmin(d)), "euclidean_2x2": d,
             "gspmd_identify_argmin_6_2x2": int(np.argmin(d[:6])),
             "gspmd_identify_argmin_12_4x1": int(np.argmin(d12))}
    return inputs, cts, plain


def _jax_wants(ck, cts):
    """The JAX package's single-device results on the same inputs, as numpy,
    keyed as the ranks key theirs."""
    import jax.numpy as jnp

    from peba1_tpu import circuits as jcc
    from peba1_tpu import gates as jgates
    from peba1_tpu import protocol as jprotocol
    from peba1_tpu.backends import CipherBackend as JCipherBackend
    from peba1_tpu.ops import bootstrap as jbs

    mu = jnp.int32(jgates.MU_1_8)
    be = JCipherBackend(ck)
    want = {}

    def put(names, *res):
        for name in names:
            for i, c in enumerate(res):
                want[f"{name}.{i}.a"], want[f"{name}.{i}.b"] = np.asarray(c.a), np.asarray(c.b)

    put(["bootstrap_2x2"], jbs.bootstrap(ck, cts["boot"], mu))
    put(["bootstrap_dp_4x1"], jbs.bootstrap(ck, cts["boot_dp"], mu))
    put(["ringtp_1x4_k1", "ringtp_2x2_k2"], jbs.bootstrap(ck, cts["ring1"], mu))
    put(["ringtp_1x4_k2"], jbs.bootstrap(ck, cts["ring2"], mu))
    put(["tree_sum_2x2", "tree_sum_1x4"], jcc.tree_sum(be, cts["words"], width=4))
    put(["argmin_2x2", "argmin_4x1"], *jcc.argmin_tree(be, cts["vals"], cts["idx"]))
    server = jprotocol.Server(ck, jprotocol.ProtocolParams(**PROTO))
    probe, tmpl = cts["probe"], cts["tmpl"]
    put(["gspmd_identify_2x2", "identify_4x1", "identify_2x2"],
        server.identify(probe, tmpl, cts["bound"]))
    put(["gspmd_identify_argmin_2x2", "identify_argmin_4x1"],
        *server.identify_argmin(probe, tmpl))
    put(["gspmd_identify_argmin_6_2x2"], *server.identify_argmin(probe, tmpl[:6]))
    tmpl12 = type(tmpl)(jnp.concatenate([tmpl.a, tmpl.a[:4]]),
                        jnp.concatenate([tmpl.b, tmpl.b[:4]]))
    put(["gspmd_identify_argmin_12_4x1"], *server.identify_argmin(probe, tmpl12))
    probe_b = type(probe)(jnp.broadcast_to(probe.a, (8,) + probe.a.shape),
                          jnp.broadcast_to(probe.b, (8,) + probe.b.shape))
    put(["euclidean_2x2"], jcc.euclidean(be, probe_b, tmpl, BITSIZE, 3 * BITSIZE))
    return want


@pytest.fixture(scope="module")
def world(toy_keys, tmp_path_factory):
    """The 4-rank world on the JAX-made inputs, and meanwhile the JAX side:
    (JAX's results, the plaintext answers, each rank's results, the secret
    key)."""
    sk, ck = toy_keys
    inputs, cts, plain = _jax_inputs(sk, ck)
    data = str(tmp_path_factory.mktemp("world"))
    np.savez(os.path.join(data, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), data],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for r in range(WORLD)]
    try:
        want = _jax_wants(ck, cts)
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}"
    ranks = [dict(np.load(os.path.join(data, f"rank{r}.npz"))) for r in range(WORLD)]
    return want, plain, ranks, sk


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_equals_jax_single_device(world, case):
    """Every rank returns the whole result, bit-equal to JAX's."""
    want, _, ranks, _ = world
    names = [f"{case}.{i}.{f}" for i in range(CASES[case]) for f in "ab"]
    for r, got in enumerate(ranks):
        for name in names:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"rank {r}: {name}")


@pytest.mark.parametrize("case", ["bootstrap_2x2", "ringtp_1x4_k1", "ringtp_1x4_k2",
                                  "tree_sum_2x2", "argmin_2x2", "identify_4x1",
                                  "identify_argmin_4x1", "euclidean_2x2",
                                  "gspmd_identify_argmin_6_2x2",
                                  "gspmd_identify_argmin_12_4x1"])
def test_sharded_decrypts_to_the_plaintext(world, case):
    import jax.numpy as jnp

    from peba1_tpu import gates as jgates
    from peba1_tpu import lwe as jlwe
    from peba1_tpu.utils.bits import bits_to_int

    _, plain, ranks, sk = world
    i = 1 if "argmin" in case else 0
    ct = jlwe.Lwe(jnp.asarray(ranks[0][f"{case}.{i}.a"]), jnp.asarray(ranks[0][f"{case}.{i}.b"]))
    bits = np.asarray(jgates.decrypt_bits(ct, sk))
    got = bits if case.startswith(("bootstrap", "ringtp")) else bits_to_int(bits)
    np.testing.assert_array_equal(got, plain[case])


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_value_errors(world, case):
    """The JAX functions' ValueErrors, raised on every rank before any
    collective (a 3x1 mesh in a world of 4 is the port's own)."""
    for got in world[2]:
        assert ERRORS[case] in str(got["error." + case])


def test_ringtp_tp_must_divide_n():
    """N % tp: no mesh of this world is one; a stand-in with tp=3 reaches the
    check, which reads only the mesh's shape."""
    from peba1_tpu_torch import keys
    from peba1_tpu_torch.parallel import shard as pshard
    from peba1_tpu_torch.params import TOY

    mesh = types.SimpleNamespace(shape=(1, 3), mesh_dim_names=("dp", "tp"))
    ck = keys.CloudKey(bk_tp=None, ks_table_limbs=None, params=TOY)
    with pytest.raises(ValueError, match="N=128 not divisible by tp=3"):
        pshard.sharded_bootstrap_ringtp(mesh, ck, None, 0)


@pytest.mark.parametrize("nj,j0", [(32, 0), (32, 32), (32, 96), (128, 0)])
def test_toeplitz_cols_match_jax_and_full(nj, j0):
    """Unit: the column slice == JAX's traced-start slice == the columns of
    the full Toeplitz matrix."""
    import jax.numpy as jnp

    from peba1_tpu.ops import poly as jpoly
    from peba1_tpu_torch.ops import poly

    N = 128
    q = np.random.default_rng(3).integers(-(2**31), 2**31, (2, 3, N)).astype(np.int32)
    vv = np.array(jpoly.prepare_toeplitz_rhs(jnp.asarray(q), 4))
    want = np.asarray(jpoly.negacyclic_toeplitz_cols(jnp.asarray(vv), jnp.int32(j0), nj))
    got = poly.negacyclic_toeplitz_cols(torch.as_tensor(vv), j0, nj).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, poly.negacyclic_toeplitz(torch.as_tensor(vv))[
        ..., j0:j0 + nj].numpy())
    np.testing.assert_array_equal(poly.doubled_neg(torch.as_tensor(q)).numpy(),
                                  np.asarray(jpoly.doubled_neg(jnp.asarray(q))))


def test_extprod_cols_match_jax_and_full():
    import jax.numpy as jnp

    from peba1_tpu.ops import poly as jpoly
    from peba1_tpu.params import TOY
    from peba1_tpu_torch.ops import poly

    p = TOY
    G = (p.k + 1) * p.l
    rng = np.random.default_rng(4)
    q = rng.integers(-(2**31), 2**31, (G, p.k + 1, p.N)).astype(np.int32)
    vv = np.array(jpoly.prepare_toeplitz_rhs(jnp.asarray(q), p.limb_plan))
    d = rng.integers(-p.half_bg, p.half_bg, (8, G, p.N)).astype(np.int8)
    full = poly.extprod_toeplitz_i8(torch.as_tensor(d), torch.as_tensor(vv), p.limb_plan)
    nj = p.N // 4
    parts = []
    for r in range(4):
        got = poly.extprod_toeplitz_cols_i8(torch.as_tensor(d), torch.as_tensor(vv),
                                            p.limb_plan, r * nj, nj)
        want = jpoly.extprod_toeplitz_cols_i8(jnp.asarray(d), jnp.asarray(vv), p.limb_plan,
                                              jnp.int32(r * nj), nj)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        parts.append(got)
    np.testing.assert_array_equal(torch.cat(parts, -1).numpy(), full.numpy())


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
