"""Key and ciphertext (de)serialization (counterpart of ``peba1_tpu/io/serial.py``).

The same npz format (``FORMAT_VERSION`` 1): the tensors plus a params JSON
member, so keys round-trip between the two packages.  A cloud key is stored
as ``bk``, ``bk_conv``, ``bk_tp`` and ``ks_table_limbs``.  Neither package
stores ``bk_w`` or ``bk_amat``: on load each is rebuilt from ``bk_tp`` where
``keys.need_w`` (``keys.need_amat``) holds (``keys.cloud_key_from_numpy``),
as ``peba1_tpu.io.serial`` does.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .. import lwe
from ..keys import CloudKey, SecretKey, cloud_key_from_numpy, secret_key_from_numpy
from ..params import TfheParams

FORMAT_VERSION = 1


def _params_to_json(p: TfheParams) -> str:
    return json.dumps({"format_version": FORMAT_VERSION, **dataclasses.asdict(p)})


def _params_from_json(s: str) -> TfheParams:
    d = json.loads(s)
    version = d.pop("format_version", None)
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported key format version {version}")
    return TfheParams(**d)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_secret_key(path: str, sk: SecretKey) -> None:
    np.savez_compressed(
        path,
        __params__=np.frombuffer(_params_to_json(sk.params).encode(), np.uint8),
        lwe_key=_np(sk.lwe_key),
        tlwe_key=_np(sk.tlwe_key),
    )


def load_secret_key(path: str, device) -> SecretKey:
    with np.load(path) as z:
        params = _params_from_json(bytes(z["__params__"]).decode())
        return secret_key_from_numpy(params, z["lwe_key"], z["tlwe_key"], device)


def save_cloud_key(path: str, ck: CloudKey) -> None:
    if ck.bk is None or ck.bk_conv is None:
        raise ValueError("saving a cloud key needs its raw TRGSW key bk and bk_conv")
    np.savez_compressed(
        path,
        __params__=np.frombuffer(_params_to_json(ck.params).encode(), np.uint8),
        bk=_np(ck.bk),
        bk_conv=_np(ck.bk_conv),
        bk_tp=_np(ck.bk_tp),
        ks_table_limbs=_np(ck.ks_table_limbs),
    )


def load_cloud_key(path: str, device) -> CloudKey:
    with np.load(path) as z:
        params = _params_from_json(bytes(z["__params__"]).decode())
        return cloud_key_from_numpy(params, z["bk_tp"], z["ks_table_limbs"],
                                    device, bk=z["bk"], bk_conv=z["bk_conv"])


def save_ciphertext(path: str, ct: lwe.Lwe, meta: dict | None = None) -> None:
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(
            {"format_version": FORMAT_VERSION, **(meta or {})}).encode(), np.uint8),
        a=_np(ct.a),
        b=_np(ct.b),
    )


def load_ciphertext(path: str, device) -> "tuple[lwe.Lwe, dict]":
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        ct = lwe.Lwe(torch.as_tensor(z["a"], device=device),
                     torch.as_tensor(z["b"], device=device))
    return ct, meta


def load_ciphertext_meta(path: str) -> dict:
    """Only the metadata record of a ciphertext archive (npz members are read
    lazily, so the tensors are never decompressed)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())
