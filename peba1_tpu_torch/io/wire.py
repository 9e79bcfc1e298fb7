"""Client/server wire protocol: framed binary codec for ciphertexts
(counterpart of ``peba1_tpu/io/wire.py``, byte for byte).

Frames are ``magic | version | kind | length | crc32c | payload`` with the
payload a JSON header and a raw little-endian tensor dump.  The byte-level
work (bit slicing, CRC, framing) runs in the repository's C extension
``peba1_native`` (native/peba1_native.c, no Python dependency) where it is
importable, and in pure Python and numpy otherwise.  This is a host codec:
tensors are copied to the host to encode, and decoded onto the device the
caller names.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from .. import lwe

try:
    import peba1_native as _native
except ImportError:  # pure-python fallback
    _native = None

KIND_CIPHERTEXT = 1
KIND_PUBLIC = 2


def have_native() -> bool:
    return _native is not None


# ------------------------------------------------------------- crc / frame

def crc32c_py(data: bytes, seed: int = 0) -> int:
    """CRC32C (Castagnoli), bit by bit: the fallback of `crc32c`."""
    crc = ~seed & 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (0x82F63B78 ^ (crc >> 1)) if crc & 1 else crc >> 1
    return ~crc & 0xFFFFFFFF


def crc32c(data: bytes, seed: int = 0) -> int:
    if _native is not None:
        return _native.crc32c(data, seed)
    return crc32c_py(data, seed)


def frame_encode(kind: int, payload: bytes, version: int = 1) -> bytes:
    if _native is not None:
        return _native.frame_encode(kind, payload, version)
    hdr = b"PEB1" + struct.pack("<HHQI", version, kind, len(payload), crc32c(payload))
    return hdr + payload


def frame_decode(data: bytes) -> "tuple[int, int, bytes]":
    if _native is not None:
        kind, version, payload = _native.frame_decode(data)
        return kind, version, payload
    if data[:4] != b"PEB1":
        raise ValueError("bad frame magic")
    version, kind, ln, crc = struct.unpack("<HHQI", data[4:20])
    payload = data[20:20 + ln]
    if len(payload) < ln or crc32c(payload) != crc:
        raise ValueError("frame CRC mismatch or truncated")
    return kind, version, payload


# --------------------------------------------------------------- bit slice

def bit_slice_py(values, nbits: int) -> np.ndarray:
    """(...,) ints -> (..., nbits) uint8 bits, LSB first: the fallback."""
    v = np.asarray(values, np.int64)
    return ((v[..., None] >> np.arange(nbits)) & 1).astype(np.uint8)


def bit_slice(values, nbits: int) -> np.ndarray:
    """(...,) ints -> (..., nbits) uint8 bits, LSB first."""
    v = np.ascontiguousarray(np.asarray(values, np.int64))
    if _native is not None:
        bits = np.frombuffer(_native.bit_slice(v.tobytes(), nbits), np.uint8)
        return bits.reshape(v.shape + (nbits,)).copy()
    return bit_slice_py(v, nbits)


def bit_unslice(bits, nbits: int | None = None) -> np.ndarray:
    """(..., nbits) bits -> (...,) int64."""
    b = np.ascontiguousarray(np.asarray(bits, np.uint8))
    if nbits is None:
        nbits = b.shape[-1]
    if _native is not None:
        vals = np.frombuffer(_native.bit_unslice(b.tobytes(), nbits), np.int64)
        return vals.reshape(b.shape[:-1]).copy()
    return (b.astype(np.int64) << np.arange(nbits)).sum(axis=-1)


# ------------------------------------------------------------ ciphertexts

def _le_i32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype("<i4"))


def encode_ciphertext(ct: lwe.Lwe, meta: dict | None = None) -> bytes:
    """One ciphertext frame: the same bytes as ``peba1_tpu.io.wire`` gives
    for the same tensors."""
    a, b = _le_i32(ct.a), _le_i32(ct.b)
    hdr = json.dumps({"a_shape": list(a.shape), "b_shape": list(b.shape),
                      **(meta or {})}).encode()
    payload = struct.pack("<I", len(hdr)) + hdr + a.tobytes() + b.tobytes()
    return frame_encode(KIND_CIPHERTEXT, payload)


def decode_ciphertext(data: bytes, device) -> "tuple[lwe.Lwe, dict]":
    """A ciphertext frame -> (Lwe on `device`, its metadata)."""
    kind, _, payload = frame_decode(data)
    if kind != KIND_CIPHERTEXT:
        raise ValueError(f"unexpected frame kind {kind}")
    (hlen,) = struct.unpack("<I", payload[:4])
    meta = json.loads(payload[4:4 + hlen].decode())
    a_shape = tuple(meta.pop("a_shape"))
    b_shape = tuple(meta.pop("b_shape"))
    na = int(np.prod(a_shape)) if a_shape else 1
    off = 4 + hlen
    a = np.frombuffer(payload, "<i4", count=na, offset=off).reshape(a_shape)
    b = np.frombuffer(payload, "<i4", offset=off + 4 * na).reshape(b_shape)
    return lwe.Lwe(torch.from_numpy(a.astype(np.int32)).to(device),
                   torch.from_numpy(b.astype(np.int32)).to(device)), meta
