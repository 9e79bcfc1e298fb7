"""The port's checkpointed 1:N sweep (peba1_tpu_torch.sweep) and its event
log, the counterparts of tests/test_sweep.py at its toy geometry (5
templates, chunks of 2), on keys and ciphertexts carried from peba1_tpu.

Invariants: (a) the collected output equals one direct `Server.identify`;
(b) a resume recomputes only the missing chunks; (c) a checkpoint directory
is bound to one sweep; (d) a directory written by peba1_tpu.sweep from the
same ciphertext tensors collects in the port, bit-equal, with the same
fingerprint.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peba1_tpu import gates as jgates
from peba1_tpu import lwe as jlwe
from peba1_tpu import sweep as jsweep
from peba1_tpu.params import TOY
from peba1_tpu.protocol import Server as JServer
from peba1_tpu.utils.bits import int_to_bits as j_int_to_bits
from peba1_tpu_torch import keys, lwe
from peba1_tpu_torch import sweep as sweep_mod
from peba1_tpu_torch.params import ProtocolParams
from peba1_tpu_torch.protocol import Server
from peba1_tpu_torch.sweep import IdentifySweep
from peba1_tpu_torch.utils.bits import bits_to_int
from peba1_tpu_torch.utils.logging import EventLog

# Toy sizes gain nothing from torch's intra-op threads; under several pytest
# workers on one machine those threads oversubscribe the cores (5.7x slower).
torch.set_num_threads(1)

PROTO = ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8, bound_match=4)
N_TEMPLATES = 5
CHUNK = 2


def to_port(ct):
    return lwe.Lwe(torch.as_tensor(np.array(ct.a)), torch.as_tensor(np.array(ct.b)))


@pytest.fixture(scope="module")
def sweep_setup(toy_keys):
    """The JAX toy keyset carried into the port, a probe, 5 templates and
    the bound encrypted by the JAX package (both packages' types), and one
    direct identify of the port."""
    sk, ck = toy_keys
    rng = np.random.default_rng(3)
    templates = rng.integers(0, 8, (N_TEMPLATES, PROTO.nslots))
    probe = np.asarray([3, 5])
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    jct = (jgates.encrypt_bits(k2, sk, j_int_to_bits(probe, PROTO.bitsize)),
           jgates.encrypt_bits(k1, sk, j_int_to_bits(templates, PROTO.bitsize)),
           jgates.encrypt_bits(k3, sk, j_int_to_bits(PROTO.bound_match, 3 * PROTO.bitsize)))
    tck = keys.cloud_key_from_numpy(TOY, np.array(ck.bk_tp), np.array(ck.ks_table_limbs),
                                    "cpu")
    server = Server(tck, PROTO)
    tct = tuple(to_port(c) for c in jct)
    direct = server.identify(*tct)
    want = (((templates - probe) ** 2).sum(1) > PROTO.bound_match).astype(int)

    def dec(ct):
        jct = jlwe.Lwe(jnp.asarray(ct.a.numpy()), jnp.asarray(ct.b.numpy()))
        return bits_to_int(np.array(jgates.decrypt_bits(jct, sk)))

    return server, tct, jct, direct, want, dec, ck


@pytest.fixture(scope="module")
def swept(sweep_setup, tmp_path_factory):
    """One whole port sweep; tests that change the directory work on a copy."""
    server, (probe_ct, templates_ct, enc_bound), *_ = sweep_setup
    d = str(tmp_path_factory.mktemp("swept") / "ckpt")
    plan = IdentifySweep(server, d, chunk=CHUNK).run(probe_ct, templates_ct, enc_bound)
    return d, plan


def copy_of(swept, tmp_path):
    d = str(tmp_path / "ckpt")
    shutil.copytree(swept[0], d)
    return d


def test_sweep_matches_direct_identify(sweep_setup, swept):
    server, _, _, direct, want, dec, _ = sweep_setup
    d, plan = swept
    sw = IdentifySweep(server, d, chunk=CHUNK)
    assert plan.n_chunks == -(-N_TEMPLATES // CHUNK)
    assert sw.completed_chunks() == list(range(plan.n_chunks))
    out = sw.collect()
    assert torch.equal(out.a, direct.a) and torch.equal(out.b, direct.b)
    np.testing.assert_array_equal(dec(out), want)


def test_sweep_resume_skips_done_chunks(sweep_setup, swept, tmp_path):
    server, (probe_ct, templates_ct, enc_bound), _, direct, _, _, _ = sweep_setup
    d = copy_of(swept, tmp_path)
    events = []
    log = EventLog()
    log.log = lambda event, **f: events.append({"event": event, **f})
    calls = []
    identify = server.identify
    server.identify = lambda *a: calls.append(a[1].shape[0]) or identify(*a)
    try:
        sw = IdentifySweep(server, d, chunk=CHUNK, log=log)
        # A crash that lost the middle chunk: only it is computed again.
        os.remove(os.path.join(d, "chunk_000001.npz"))
        sw.run(probe_ct, templates_ct, enc_bound)
    finally:
        server.identify = identify
    done = [e for e in events if e["event"] == "sweep_done"][0]
    assert done["computed"] == 1 and done["resumed_from"] == 2
    assert calls == [CHUNK]
    assert [e["chunk"] for e in events if e["event"] == "sweep_chunk"] == [1]
    out = sw.collect()
    assert torch.equal(out.b, direct.b)


def test_sweep_rejects_foreign_checkpoint(sweep_setup, swept, tmp_path):
    server, (probe_ct, templates_ct, enc_bound), _, direct, *_ = sweep_setup
    d = copy_of(swept, tmp_path)
    # Another geometry, so another fingerprint: resuming is refused ...
    sw3 = IdentifySweep(server, d, chunk=3)
    with pytest.raises(ValueError, match="different sweep"):
        sw3.run(probe_ct, templates_ct, enc_bound)
    # ... and resume=False wipes the directory and runs cleanly.
    plan = sw3.run(probe_ct, templates_ct, enc_bound, resume=False)
    assert sw3.completed_chunks() == list(range(plan.n_chunks)) == [0, 1]
    assert not os.path.exists(os.path.join(d, "chunk_000002.npz"))
    assert torch.equal(sw3.collect().b, direct.b)


def test_collect_flags_fingerprint_mismatch(sweep_setup, swept, tmp_path):
    server = sweep_setup[0]
    d = copy_of(swept, tmp_path)
    mpath = os.path.join(d, sweep_mod.MANIFEST)
    with open(mpath) as f:
        m = json.load(f)
    m["fingerprint"] = "0" * 16
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="different sweep"):
        IdentifySweep(server, d, chunk=CHUNK).collect()


def test_reference_checkpoint_collects_in_the_port(sweep_setup, tmp_path):
    """peba1_tpu.sweep writes the directory from the same ciphertext tensors
    and the same cloud key; the port verifies every chunk (0 computed),
    finds the same fingerprint and collects the same tensors as its own
    direct identify."""
    server, tct, jct, direct, want, dec, jck = sweep_setup
    d = str(tmp_path / "ckpt")
    jsw = jsweep.IdentifySweep(JServer(jck, PROTO), d, chunk=CHUNK)
    jplan = jsw.run(*jct)
    events = []
    log = EventLog()
    log.log = lambda event, **f: events.append({"event": event, **f})
    sw = IdentifySweep(server, d, chunk=CHUNK, log=log)
    plan = sw.run(*tct)
    assert plan.fingerprint == jplan.fingerprint
    assert [e for e in events if e["event"] == "sweep_done"][0]["computed"] == 0
    out = sw.collect()
    jout = jsw.collect()
    np.testing.assert_array_equal(out.a.numpy(), np.asarray(jout.a))
    np.testing.assert_array_equal(out.b.numpy(), np.asarray(jout.b))
    assert torch.equal(out.a, direct.a) and torch.equal(out.b, direct.b)
    np.testing.assert_array_equal(dec(out), want)


def test_event_log_jsonl(tmp_path):
    p = str(tmp_path / "events.jsonl")
    log = EventLog(path=p, context={"run": "t"})
    log.log("hello", x=1, t=torch.tensor([1, 2]), a=np.int64(3))
    with log.timer("timed", tag="a") as extra:
        extra["items"] = 3
    child = log.child(sub="c")
    child.log("inner")
    child.close()                         # a child does not close the file
    log.close()
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["event"] == "hello" and lines[0]["x"] == 1 and lines[0]["run"] == "t"
    assert lines[0]["t"] == [1, 2] and lines[0]["a"] == 3
    assert lines[1]["event"] == "timed" and lines[1]["seconds"] >= 0
    assert lines[1]["tag"] == "a" and lines[1]["items"] == 3
    assert lines[2]["event"] == "inner" and lines[2]["sub"] == "c" and lines[2]["run"] == "t"
