"""The system under test: ``peba1_tpu_torch``, reached through its own entry
points.

The benchmark hands the program the raw key material through the program's
key-loading entry (`keys.secret_key_from_numpy`, `keys.cloud_key_from_numpy`)
after the program has derived its key forms from it (`ops.poly`).  The
server's gate backend is `HarnessBackend`, a `backends.CipherBackend` that
puts the harness's span around every bootstrap call and tells an observer
of each call.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from peba1_tpu_torch import keys as port_keys
from peba1_tpu_torch import lwe
from peba1_tpu_torch.backends import CipherBackend
from peba1_tpu_torch.ops import poly
from peba1_tpu_torch.params import ProtocolParams, TfheParams
from peba1_tpu_torch.protocol import ClientDevice, Server

from .trace import CALL_SPAN


def params(config: dict) -> TfheParams:
    """The program's parameters: the configuration's `tfhe` numbers and
    `kernel` flags."""
    return TfheParams(**config["tfhe"], **config["kernel"])


def protocol(config: dict) -> ProtocolParams:
    return ProtocolParams(**config["protocol"])


def load_keys(p: TfheParams, raw, device) -> "tuple":
    """(secret key, cloud key) of the program from the raw material."""
    sk = port_keys.secret_key_from_numpy(p, raw.lwe_key.cpu().numpy(),
                                         raw.tlwe_key.cpu().numpy(), device)
    bk_tp = poly.prepare_toeplitz_rhs(raw.bk, p.limb_plan)
    kn_t = p.k * p.N * p.ks_t
    ks_limbs = poly.split_limbs_i8(raw.ks, 4).reshape(kn_t, (p.n + 1) * 4)
    ck = port_keys.cloud_key_from_numpy(p, bk_tp.cpu().numpy(), ks_limbs.cpu().numpy(),
                                        device)
    return sk, ck


def ciphertext(a: torch.Tensor, b: torch.Tensor):
    return lwe.Lwe(a, b)


class Observer:
    """Told of every bootstrap call the backend makes; does nothing."""

    def before(self) -> None:
        pass

    def after(self, kind: str, names, inputs, output) -> None:
        pass


class HarnessBackend(CipherBackend):
    """The program's gate backend, each bootstrap call (a gate, a MUX or a
    circuit level) inside the harness's span and reported to `observer`."""

    def __init__(self, ck, observer: Observer):
        super().__init__(ck)
        self.observer = observer

    def _call(self, kind, names, inputs, fn):
        self.observer.before()
        with record_function(CALL_SPAN):
            out = fn()
        self.observer.after(kind, names, inputs, out)
        return out

    def gate(self, name, a, b):
        return self._call("gate", [name], [(a, b)],
                          lambda: CipherBackend.gate(self, name, a, b))

    def MUX(self, a, b, c):
        return self._call("mux", ["MUX"], [(a, b, c)], lambda: CipherBackend.MUX(self, a, b, c))

    def level(self, ops):
        return self._call("level", [name for name, _, _ in ops],
                          [(a, b) for _, a, b in ops], lambda: CipherBackend.level(self, ops))


def client_and_server(sk, ck, proto: ProtocolParams, observer: Observer):
    """The protocol's two parties, the server on the harness's backend."""
    server = Server(ck, proto)
    server.be = HarnessBackend(ck, observer)
    return ClientDevice(7, sk, ck, proto), server
