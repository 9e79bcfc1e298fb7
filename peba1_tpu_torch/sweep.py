"""Checkpoint/resume engine for long 1:N identification sweeps (counterpart
of ``peba1_tpu/sweep.py``).

The template database is split into fixed-size chunks; each chunk is one
batched `Server.identify` call whose encrypted decision words are written to
``<dir>/chunk_<i>.npz`` (io.serial format) beside a ``manifest.json`` that
records the sweep's geometry and a content fingerprint of its inputs.
`run()` skips chunks whose file already exists and carries the manifest's
fingerprint, so running again after a crash resumes where it stopped;
`collect()` reassembles the (N, 3*bitsize) decision words.  Writes are
atomic (a temporary file, then a rename), so a kill mid-write never leaves a
truncated chunk that a resume would trust.

The fingerprint hashes the same bytes as the JAX package's (C-contiguous
little-endian int32 of the ciphertexts), so a checkpoint directory written
by either package from the same ciphertext tensors verifies in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from . import lwe
from .io import serial
from .utils.logging import NULL_LOG, EventLog

MANIFEST = "manifest.json"


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    n_templates: int
    chunk: int
    fingerprint: str
    # Manifest schema version.  1 = fingerprint of probe, bound and geometry
    # only; 2 = the template database bound into the fingerprint as well.
    schema: int = 2

    @property
    def n_chunks(self) -> int:
        return -(-self.n_templates // self.chunk)

    def chunk_range(self, i: int) -> "tuple[int, int]":
        lo = i * self.chunk
        return lo, min(lo + self.chunk, self.n_templates)


def _le_bytes(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype("<i4")).tobytes()


def _fingerprint(probe_ct: lwe.Lwe, enc_bound: lwe.Lwe, n_templates: int,
                 chunk: int, database_id: str) -> str:
    """Content hash binding a checkpoint directory to one (probe, bound,
    database) sweep: the probe and bound ciphertexts, the geometry and the
    database's identity string."""
    h = hashlib.sha256()
    for t in (probe_ct.a, probe_ct.b, enc_bound.a, enc_bound.b):
        h.update(_le_bytes(t))
    h.update(json.dumps({"n": n_templates, "chunk": chunk,
                         "db": database_id}).encode())
    return h.hexdigest()[:16]


def _database_id(templates_ct: lwe.Lwe) -> str:
    """Content identity of the template database: a hash of the LWE bodies
    only (one (N, nslots, bitsize) int32 copy to the host; the masks stay on
    the device)."""
    return hashlib.sha256(_le_bytes(templates_ct.b)).hexdigest()[:16]


def _chunk_path(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"chunk_{i:06d}.npz")


def _atomic_save(path: str, ct: lwe.Lwe, meta: dict) -> None:
    tmp = path + ".tmp.npz"   # np.savez adds no suffix to a name ending .npz
    serial.save_ciphertext(tmp, ct, meta)
    os.replace(tmp, path)


class IdentifySweep:
    """Chunked, checkpointed 1:N identification (one probe against N
    templates).

    server: protocol.Server (cloud key only); out_dir: the checkpoint
    directory, created if missing; chunk: templates per `Server.identify`
    call (larger batches the card better, smaller resumes finer); log: an
    EventLog for progress events.
    """

    def __init__(self, server, out_dir: str, chunk: int = 256,
                 log: EventLog = NULL_LOG):
        self.server = server
        self.out_dir = out_dir
        self.chunk = chunk
        self.log = log
        os.makedirs(out_dir, exist_ok=True)

    # -- manifest ---------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.out_dir, MANIFEST)

    def _load_manifest(self) -> Optional[dict]:
        p = self._manifest_path()
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def _write_manifest(self, plan: SweepPlan) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(plan), f)
        os.replace(tmp, self._manifest_path())

    # -- entry points -----------------------------------------------------
    def run(self, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe, enc_bound: lwe.Lwe,
            resume: bool = True, database_id: Optional[str] = None) -> SweepPlan:
        """Sweep all templates, checkpointing each chunk; returns the plan.

        templates_ct: (N, nslots, bitsize) encrypted template database.
        database_id: a caller's version string for the database; when None,
        a hash of the template bodies.  Either way the database is bound
        into the fingerprint.  On resume, chunks already on disk (matching
        manifest and per-chunk fingerprint) are skipped without touching the
        device.
        """
        n_templates = templates_ct.shape[0]
        if database_id is None:
            database_id = _database_id(templates_ct)
        plan = SweepPlan(n_templates=n_templates, chunk=self.chunk,
                         fingerprint=_fingerprint(probe_ct, enc_bound, n_templates,
                                                  self.chunk, database_id))
        prev = self._load_manifest()
        if prev is not None and prev != dataclasses.asdict(plan):
            if resume:
                if prev.get("schema", 1) != plan.schema:
                    raise ValueError(
                        f"checkpoint dir {self.out_dir} was written with manifest "
                        f"schema v{prev.get('schema', 1)} (this version uses "
                        f"v{plan.schema}, whose fingerprint binds the template "
                        "database); its chunks cannot be verified: recompute in a "
                        "fresh directory or pass resume=False to overwrite")
                raise ValueError(
                    f"checkpoint dir {self.out_dir} holds a different sweep "
                    f"({prev} != {dataclasses.asdict(plan)}); pass resume=False "
                    "to overwrite or use a fresh directory")
            for i in range(prev.get("n_templates", 0) // max(prev.get("chunk", 1), 1) + 1):
                p = _chunk_path(self.out_dir, i)
                if os.path.exists(p):
                    os.remove(p)
        self._write_manifest(plan)

        done = skipped = 0
        for i in range(plan.n_chunks):
            path = _chunk_path(self.out_dir, i)
            if resume and os.path.exists(path):
                # A stale or foreign chunk in a directory whose manifest was
                # lost is recomputed now, not discovered in collect().
                try:
                    meta = serial.load_ciphertext_meta(path)
                except Exception:
                    meta = {}
                if meta.get("fingerprint") == plan.fingerprint:
                    skipped += 1
                    continue
                os.remove(path)
            lo, hi = plan.chunk_range(i)
            with self.log.timer("sweep_chunk", chunk=i, lo=lo, hi=hi):
                out = self.server.identify(probe_ct, templates_ct[lo:hi], enc_bound)
                if out.b.device.type == "cuda":
                    torch.cuda.synchronize(out.b.device)
                _atomic_save(path, out, {"chunk": i, "lo": lo, "hi": hi,
                                         "fingerprint": plan.fingerprint})
            done += 1
        self.log.log("sweep_done", n_chunks=plan.n_chunks, computed=done,
                     resumed_from=skipped)
        return plan

    def completed_chunks(self) -> "list[int]":
        m = self._load_manifest()
        if m is None:
            return []
        plan = SweepPlan(**m)
        return [i for i in range(plan.n_chunks)
                if os.path.exists(_chunk_path(self.out_dir, i))]

    def collect(self, device="cpu") -> lwe.Lwe:
        """All chunk outputs as (N, 3*bitsize) decision words on `device`."""
        m = self._load_manifest()
        if m is None:
            raise FileNotFoundError(f"no manifest in {self.out_dir}")
        plan = SweepPlan(**m)
        parts = []
        for i in range(plan.n_chunks):
            ct, meta = serial.load_ciphertext(_chunk_path(self.out_dir, i), device)
            if meta.get("fingerprint") != plan.fingerprint:
                raise ValueError(f"chunk {i} belongs to a different sweep")
            parts.append(ct)
        return lwe.concatenate(parts)
