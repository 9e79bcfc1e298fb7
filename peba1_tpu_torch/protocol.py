"""PEBA1 protocol layer: privacy-preserving biometric authentication.

Counterpart of ``peba1_tpu/protocol.py``.  ``ClientDevice`` holds the secret
key and does enroll/encrypt/decrypt/prove; ``Server`` holds only the cloud
key and computes Function_f / Function_g; nothing server-side can decrypt.

Decision semantics (faithful to the reference's gate outputs):
  b = Function_f = [ED(probe, template) > bound]   (1 = NO match)
  y = Function_g = r1 if b == 1 else (-r0 mod 2^bitsize)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import circuits as cc
from . import gates, lwe
from .backends import CipherBackend
from .keys import CloudKey, SecretKey, keygen
from .params import PEBA1_PROTOCOL, ProtocolParams, TfheParams
from .utils.bits import bits_to_int, int_to_bits
from .utils.logging import span


@dataclasses.dataclass
class ClientRecord:
    """Server-side view of an enrolled client: ID + encrypted template ONLY."""

    client_id: int
    template_ct: lwe.Lwe          # (..., nslots, bitsize) encrypted bits
    nslots: int

    def get_id(self) -> int:
        return self.client_id

    def get_ctxt(self) -> lwe.Lwe:
        return self.template_ct

    def get_nb_slots(self) -> int:
        return self.nslots


class ClientDevice:
    """Client-side identity: secret key + plaintext biometrics; the only
    object in the system that can encrypt/decrypt."""

    def __init__(self, client_id: int, sk: SecretKey, ck: CloudKey,
                 proto: ProtocolParams = PEBA1_PROTOCOL, minimum_lambda: int = 128):
        self.client_id = client_id
        self.sk = sk
        self.ck = ck  # public cloud key (shared with the server)
        self.proto = proto
        self.minimum_lambda = minimum_lambda

    def encrypt_vector(self, gen: torch.Generator, values) -> lwe.Lwe:
        """values (..., nslots) ints -> encrypted bits (..., nslots, bitsize)."""
        bits = int_to_bits(values, self.proto.bitsize, self.sk.device)
        return gates.encrypt_bits(gen, self.sk, bits)

    def encrypt_word(self, gen: torch.Generator, value, nbits: int) -> lwe.Lwe:
        return gates.encrypt_bits(gen, self.sk, int_to_bits(value, nbits, self.sk.device))

    def decrypt_word(self, ct: lwe.Lwe) -> np.ndarray:
        """(..., nbits) ciphertext -> (...,) ints."""
        return bits_to_int(gates.decrypt_bits(ct, self.sk))

    def enroll(self, gen: torch.Generator, template_values) -> ClientRecord:
        return ClientRecord(client_id=self.client_id,
                            template_ct=self.encrypt_vector(gen, template_values),
                            nslots=self.proto.nslots)

    def prove(self, enc_y: lwe.Lwe) -> np.ndarray:
        """Decrypt the blinded nonce y to return to the server."""
        return self.decrypt_word(enc_y)


@dataclasses.dataclass
class AuthResult:
    enc_b: lwe.Lwe   # encrypted decision word (3*bitsize bits)
    enc_y: lwe.Lwe   # encrypted blinded nonce (bitsize bits)
    r0: np.ndarray
    r1: np.ndarray


def _broadcast_lead(ct: lwe.Lwe, n: int, tail: int) -> lwe.Lwe:
    """Broadcast ct's last `tail` batch dims to a new leading dim of size n."""
    shape = (n,) + ct.shape[len(ct.shape) - tail:]
    return gates.expand(ct, shape)


class Server:
    """Holds only the cloud key; computes the protocol homomorphically."""

    def __init__(self, ck: CloudKey, proto: ProtocolParams = PEBA1_PROTOCOL):
        self.ck = ck
        self.proto = proto
        self.be = CipherBackend(ck)
        self.db: dict[int, ClientRecord] = {}

    def register(self, record: ClientRecord) -> None:
        self.db[record.client_id] = record

    def function_f(self, probe_ct: lwe.Lwe, template_ct: lwe.Lwe,
                   enc_bound: lwe.Lwe) -> lwe.Lwe:
        return cc.function_f(self.be, probe_ct, template_ct, enc_bound,
                             self.proto.bitsize)

    def function_g(self, enc_b: lwe.Lwe, enc_r0: lwe.Lwe, enc_r1: lwe.Lwe) -> lwe.Lwe:
        return cc.function_g(self.be, enc_b, enc_r0, enc_r1, self.proto.bitsize)

    def authenticate(self, gen: torch.Generator, probe_ct: lwe.Lwe,
                     template_ct: lwe.Lwe, enc_bound: lwe.Lwe) -> AuthResult:
        """Run f then g with fresh nonces.  Batched over leading dims.

        The nonces are trivial (noiseless public) ciphertexts, which the
        cloud-key-only server can construct itself.
        """
        shape = probe_ct.shape[:-2]
        # Nonces in [0, 2^bitsize), drawn on the generator's device.
        hi = 1 << self.proto.bitsize
        r0 = torch.randint(0, hi, shape, generator=gen, device=gen.device).cpu().numpy()
        r1 = torch.randint(0, hi, shape, generator=gen, device=gen.device).cpu().numpy()
        be = self.be
        enc_b = self.function_f(probe_ct, template_ct, enc_bound)
        enc_r0 = cc.const_word(be, r0, self.proto.bitsize, shape)
        enc_r1 = cc.const_word(be, r1, self.proto.bitsize, shape)
        enc_y = self.function_g(enc_b, enc_r0, enc_r1)
        return AuthResult(enc_b=enc_b, enc_y=enc_y, r0=r0, r1=r1)

    def verify_proof(self, result: AuthResult, y: np.ndarray) -> dict:
        """Server-side verdicts given the client's decrypted y.

        reference_verdict: the reference driver's check, y == r1 -- true
          exactly when ed > bound.
        is_match: the semantically-correct acceptance, ed <= bound.
        """
        ref = np.asarray(y) == result.r1
        return {"reference_verdict": ref, "is_match": ~ref}

    def identify(self, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe,
                 enc_bound: lwe.Lwe) -> lwe.Lwe:
        """Match one probe against N templates: (N, 3*bitsize) words of
        encrypted non-match bits (b_i = 1 iff ED(probe, t_i) > bound), as ONE
        batched circuit evaluation."""
        n_templates = templates_ct.shape[0]
        probe_b = _broadcast_lead(probe_ct, n_templates, 2)
        bound_b = _broadcast_lead(enc_bound, n_templates, 1)
        return self.function_f(probe_b, templates_ct, bound_b)

    def identify_argmin(self, probe_ct: lwe.Lwe,
                        templates_ct: lwe.Lwe) -> "tuple[lwe.Lwe, lwe.Lwe]":
        """1:N identification via encrypted tournament argmin: returns
        (enc_min_dist (max_bitsize,), enc_idx (ibits,)), ties -> lowest index."""
        n_templates = templates_ct.shape[0]
        probe_b = _broadcast_lead(probe_ct, n_templates, 2)
        be = self.be
        with span("identify.distance"):
            dists = cc.euclidean(be, probe_b, templates_ct, self.proto.bitsize,
                                 self.proto.max_bitsize)
        ibits = max(1, (n_templates - 1).bit_length())
        idx_words = cc.const_word(be, np.arange(n_templates), ibits, (n_templates,))
        with span("identify.argmin"):
            return cc.argmin_tree(be, dists, idx_words)


def make_system(gen: torch.Generator, params: TfheParams, device, client_id: int = 7,
                proto: ProtocolParams = PEBA1_PROTOCOL):
    """Keygen on `device` + client device + server (the reference's main.cpp
    set-up; its ID 007 is octal, so 7)."""
    sk, ck = keygen(gen, params, device)
    return ClientDevice(client_id, sk, ck, proto), Server(ck, proto)
