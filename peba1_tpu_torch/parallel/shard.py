"""Sharded bootstrap and protocol execution over a ('dp', 'tp') mesh.

Counterpart of ``peba1_tpu/parallel/shard.py``:
  * the ciphertext batch shards over dp; every rank holds the bootstrapping
    key and runs the full blind rotation on its shard (gate bootstraps are
    independent across the batch);
  * the keyswitch digit matmul splits over tp by output columns (the n+1
    LWE coefficients x limbs), joined by an all_gather;
  * ring-TP splits the external product over the ring's output
    coefficients, one all_gather a step;
  * 1:N identification shards the template database over dp; the
    sharded argmin forms play a local tournament per shard, gather the dp
    finalists and finish the tournament on every rank, and the GSPMD form
    gathers the distances and plays the whole tournament on every rank.

Calling convention.  The JAX functions take global arrays and return global
ones, and XLA partitions the program.  Here every rank calls the function
with the same global inputs on its own device (SPMD), takes its slice,
computes through the port's own modules (``ops/bootstrap.blind_rotate``, so
on the card the preset's hand-written kernel; ``backends.CipherBackend`` and
``circuits``), and joins the pieces with explicit all_gathers over the
mesh's process groups, in the order the JAX collectives give (a tiled
gather is a ``cat`` in rank order, a non-tiled one a ``stack``).  Every rank
returns the whole result.  Integer arithmetic and identical reduction trees
make every function bit-equal to its single-device form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import circuits as cc
from .. import gates, lwe, tlwe
from ..backends import CipherBackend
from ..keys import CloudKey, slim_for_bootstrap
from ..ops import bootstrap as bs
from ..ops import decompose as dec
from ..ops import poly, rotate
from .mesh import axis_size


def _gather(x: torch.Tensor, mesh, axis: str, async_op: bool = False):
    """all_gather of x over this rank's `axis` group: the list of every
    rank's x in rank order (and the pending work with `async_op`)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    work = dist.all_gather(out, x, group=mesh.get_group(axis), async_op=async_op)
    return (out, work) if async_op else out


def _gather_lwe(ct: lwe.Lwe, mesh, axis: str) -> lwe.Lwe:
    """Tiled gather along the leading batch dim (shards back to the whole)."""
    return lwe.Lwe(torch.cat(_gather(ct.a, mesh, axis)), torch.cat(_gather(ct.b, mesh, axis)))


def _slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible by {axis}={n}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * size, size)


def shard_keyswitch_table(ck: CloudKey, n_tp: int) -> torch.Tensor:
    """The KS table for tp column sharding: (M, C) -> (tp, M, C/tp), the
    columns zero-padded to a multiple of tp."""
    t = ck.ks_table_limbs
    m, c = t.shape
    pad = (-c) % n_tp
    t = torch.cat([t, t.new_zeros((m, pad))], dim=1)
    return t.reshape(m, n_tp, (c + pad) // n_tp).permute(1, 0, 2)


def _keyswitch_tp(mesh, ck: CloudKey, a_ext: torch.Tensor, b_ext: torch.Tensor) -> lwe.Lwe:
    """The key switch with its matmul split over tp: this rank's column
    slice of the table, the partial columns gathered tiled over tp."""
    p = ck.params
    ks_cols = shard_keyswitch_table(ck, axis_size(mesh, "tp"))[mesh.get_local_rank("tp")]
    part = poly.exact_matmul(bs.keyswitch_digits(p, a_ext), ks_cols).to(torch.int32)
    cols = torch.cat(_gather(part, mesh, "tp"), dim=1)[:, :(p.n + 1) * 4]
    acc32 = poly.recombine_limbs_i32(cols.reshape(-1, p.n + 1, 4), 4)
    return lwe.Lwe(-acc32[:, :p.n], b_ext - acc32[:, p.n])


def sharded_bootstrap(mesh, ck: CloudKey, ct: lwe.Lwe, mu: int) -> lwe.Lwe:
    """Batched gate bootstrap with the batch sharded over dp and the
    keyswitch matmul over tp.  ct: (B,), B divisible by dp.

    The blind rotation is ``ops/bootstrap.blind_rotate`` on the key that
    ``keys.slim_for_bootstrap`` leaves, so on the card it launches the
    preset's kernel (cmux_step_gen at peba1_128_t2_gen) once a call.
    """
    p = ck.params
    local = shard_lwe(mesh, ct, ("dp",))
    bara = rotate.modswitch_2n(local.a, p.N)
    barb = rotate.modswitch_2n(local.b, p.N)
    acc = bs.blind_rotate(slim_for_bootstrap(ck), bara, barb, mu)
    a_ext, b_ext = tlwe.sample_extract(acc)
    return _gather_lwe(_keyswitch_tp(mesh, ck, a_ext, b_ext), mesh, "dp")


def sharded_bootstrap_ringtp(mesh, ck: CloudKey, ct: lwe.Lwe, mu: int,
                             overlap_blocks: int = 1) -> lwe.Lwe:
    """Gate bootstrap with the ring dimension tensor-parallel over tp.

    tp rank r computes only output columns [r*N/tp, (r+1)*N/tp) of each
    step's external product, from its column slice of the Toeplitz weights
    built from the replicated generator ``bk_tp``
    (`poly.extprod_toeplitz_cols_i8`), and the step's delta is joined by one
    tiled all_gather over tp.  The accumulator stays replicated within a tp
    group; the rotation and the digits, plain torch as in the JAX package,
    are computed on every rank.  The batch shards over dp, and the keyswitch
    reuses `sharded_bootstrap`'s tp column split.  Bit-equal to the
    single-device bootstrap: every output coefficient is an independent
    integer dot.

    overlap_blocks (K > 1): each rank's N/tp columns split into K blocks,
    and each block's delta is gathered (asynchronously) as soon as its
    product is done, while the next block's product runs; the gathered
    columns are reassembled in (rank, block, column) order.
    """
    p = ck.params
    n_tp = axis_size(mesh, "tp")
    if p.N % n_tp != 0:
        raise ValueError(f"N={p.N} not divisible by tp={n_tp}")
    nj = p.N // n_tp
    K = overlap_blocks
    if K < 1 or nj % K != 0:
        raise ValueError(f"overlap_blocks={K} must divide the per-rank "
                         f"column count N/tp={nj}")
    njb = nj // K
    j0 = mesh.get_local_rank("tp") * nj
    local = shard_lwe(mesh, ct, ("dp",))
    Bl = local.shape[0]
    bara = rotate.modswitch_2n(local.a, p.N)
    barb = rotate.modswitch_2n(local.b, p.N)
    acc = rotate.initial_accumulator((2 * p.N - barb) % (2 * p.N), mu, p).view(
        Bl, p.k + 1, p.N)
    amt = bara.T
    for s in range(p.n):
        rot = rotate.negacyclic_rotate(acc, amt[s][:, None])
        d = dec.decompose(rot - acc, p)                       # (Bl, k+1, N, l)
        d = d.movedim(-1, -2).reshape(Bl, (p.k + 1) * p.l, p.N)
        vv = ck.bk_tp[s]
        if K == 1:
            cols = poly.extprod_toeplitz_cols_i8(d, vv, p.limb_plan, j0, nj)
            delta = torch.cat(_gather(cols, mesh, "tp"), dim=-1)
        else:
            pending = [_gather(poly.extprod_toeplitz_cols_i8(
                d, vv, p.limb_plan, j0 + b * njb, njb), mesh, "tp", async_op=True)
                for b in range(K)]
            for _, work in pending:
                work.wait()
            # pending[b][0][r]: (Bl, k+1, njb), global columns r*nj + b*njb + c.
            delta = torch.cat([pending[b][0][r] for r in range(n_tp) for b in range(K)],
                              dim=-1)
        acc = acc + delta
    a_ext, b_ext = tlwe.sample_extract(acc)
    return _gather_lwe(_keyswitch_tp(mesh, ck, a_ext, b_ext), mesh, "dp")


def _tree_sum_local_then_global(be, words: lwe.Lwe, width: int, mesh) -> lwe.Lwe:
    """Local log-depth bootstrapped adder tree over this rank's slots, then
    a gather of the tp partial words into a new axis before the bit axis and
    the same tree over them.  For power-of-two slots per shard and tp the
    whole addition tree is circuits.tree_sum's, so the result is bit-equal."""
    part = cc.tree_sum(be, words, width)              # word (..., W)
    ga = torch.stack(_gather(part.a, mesh, "tp"), dim=part.a.ndim - 2)
    gb = torch.stack(_gather(part.b, mesh, "tp"), dim=part.b.ndim - 1)
    return cc.tree_sum(be, lwe.Lwe(ga, gb), width)


def _check_tp_slots(nslots: int, n_tp: int, op: str) -> None:
    if nslots % n_tp != 0:
        raise ValueError(f"{op}: nslots={nslots} not divisible by tp={n_tp}")
    local_slots = nslots // n_tp
    if local_slots & (local_slots - 1) or n_tp & (n_tp - 1):
        raise ValueError(
            f"{op} needs power-of-two slots per shard and tp "
            f"(got {local_slots} x {n_tp}) for tree-equality with tree_sum")


def sharded_tree_sum(mesh, ck: CloudKey, words_ct: lwe.Lwe, width: int) -> lwe.Lwe:
    """Encrypted slot-sum reduction split over tp: a bootstrapped adder tree
    over nslots/tp slots per rank, a gather of the tp partial words, and
    the finish on every rank.  Bit-equal to circuits.tree_sum for
    power-of-two shards.

    words_ct: (..., nslots, W) bit-words, the slot axis split over tp and a
    leading batch axis, if any, over dp.  Returns (..., W).
    """
    _check_tp_slots(words_ct.shape[-2], axis_size(mesh, "tp"), "sharded_tree_sum")
    lead = len(words_ct.shape) - 2
    spec = ("dp",) + (None,) * (lead - 1) + ("tp", None) if lead else ("tp", None)
    be = CipherBackend(slim_for_bootstrap(ck))
    out = _tree_sum_local_then_global(be, shard_lwe(mesh, words_ct, spec), width, mesh)
    return _gather_lwe(out, mesh, "dp") if lead else out


def sharded_euclidean(mesh, ck: CloudKey, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe,
                      bitsize: int, max_bitsize: int) -> lwe.Lwe:
    """Encrypted squared-Euclidean distance with the slot reduction split
    over tp and the templates over dp: |b_i - a_i| and its square on this
    rank's slots, then `sharded_tree_sum`'s local tree and gathered finish.
    Bit-equal to circuits.euclidean for power-of-two shards.

    probe_ct: (nslots, bitsize); templates_ct: (M, nslots, bitsize).
    Returns (M, max_bitsize).
    """
    _check_tp_slots(templates_ct.shape[-2], axis_size(mesh, "tp"), "sharded_euclidean")
    be = CipherBackend(slim_for_bootstrap(ck))
    t = shard_lwe(mesh, templates_ct, ("dp", "tp"))
    pr = shard_lwe(mesh, probe_ct, ("tp",))
    probe_b = gates.expand(pr, (t.shape[0],) + pr.shape)
    diffs = cc.sub_abs(be, t, probe_b, bitsize)       # this rank's slots only
    sq = cc.multiply(be, diffs[..., :bitsize], diffs[..., :bitsize], bitsize,
                     length=max_bitsize - 1)
    total = _tree_sum_local_then_global(be, sq, max_bitsize - 1, mesh)
    zero = be.CONSTANT(0, total[..., 0].shape + (1,))
    return _gather_lwe(be.concat([total, zero], axis=-1), mesh, "dp")


def _check_dp_templates(n_templates: int, mesh) -> None:
    dp = axis_size(mesh, "dp")
    if n_templates % dp != 0:
        raise ValueError(f"n_templates={n_templates} not divisible by dp={dp}")


def sharded_identify(mesh, ck: CloudKey, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe,
                     enc_bound: lwe.Lwe, bitsize: int) -> lwe.Lwe:
    """1:N identification with the template database sharded over dp: each
    rank runs the whole Function_f circuit on its N/dp templates, with no
    collective until the (N, 3*bitsize) verdict words are gathered.  Equal
    to protocol.Server.identify on one device (per-template independence).
    """
    _check_dp_templates(templates_ct.shape[0], mesh)
    be = CipherBackend(slim_for_bootstrap(ck))
    t = shard_lwe(mesh, templates_ct, ("dp",))
    m = t.shape[0]
    probe_b = gates.expand(probe_ct, (m,) + probe_ct.shape)
    bound_b = gates.expand(enc_bound, (m,) + enc_bound.shape)
    return _gather_lwe(cc.function_f(be, probe_b, t, bound_b, bitsize), mesh, "dp")


def shard_lwe(mesh, ct: lwe.Lwe, spec) -> lwe.Lwe:
    """This rank's block of ct: spec names the mesh axis each leading batch
    dim is split over (None: kept whole); the mask's trailing dim stays
    whole.  A dim that the axis does not divide raises ValueError."""
    a, b = ct.a, ct.b
    for dim, axis in enumerate(spec):
        if axis is not None:
            a, b = _slice(a, mesh, axis, dim), _slice(b, mesh, axis, dim)
    return lwe.Lwe(a, b)


def replicate_lwe(mesh, ct: lwe.Lwe) -> lwe.Lwe:
    """ct, whole, on this rank's device: the mesh's device type, and on the
    card the device `init_distributed` made current."""
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
              else torch.device(mesh.device_type))
    return lwe.Lwe(ct.a.to(device), ct.b.to(device))


def gspmd_identify(mesh, server, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe,
                   enc_bound: lwe.Lwe) -> lwe.Lwe:
    """1:N identification in the JAX package's GSPMD form: the template
    database placed dp-sharded, probe and bound replicated, and the normal
    per-level ``Server.identify`` run on each rank's slice; the verdicts are
    gathered over dp.  PyTorch has no GSPMD partitioner; this is the
    program XLA's partitioning computes (the gate math is batch-elementwise,
    so the per-level programs carry no collectives)."""
    t = shard_lwe(mesh, templates_ct, ("dp",))
    out = server.identify(replicate_lwe(mesh, probe_ct), t, replicate_lwe(mesh, enc_bound))
    return _gather_lwe(out, mesh, "dp")


def gspmd_identify_argmin(mesh, server, probe_ct: lwe.Lwe, templates_ct: lwe.Lwe):
    """Tournament argmin in the GSPMD form (see `gspmd_identify`): the
    distances of this rank's templates through the server's circuit,
    gathered over dp (tiled, in rank order) into the whole (N, max_bitsize)
    axis, and ``circuits.argmin_tree`` over all N templates with the global
    index words on every rank.  That is the program XLA's partitioning
    computes for JAX's form, which runs the normal
    ``Server.identify_argmin`` on dp-placed templates, so the result is
    bit-equal to ``Server.identify_argmin`` at every N that dp divides.
    Returns (enc_min_dist, enc_idx)."""
    n_templates = templates_ct.shape[0]
    _check_dp_templates(n_templates, mesh)
    be, proto = server.be, server.proto
    t = shard_lwe(mesh, templates_ct, ("dp",))
    pr = replicate_lwe(mesh, probe_ct)
    dists = cc.euclidean(be, gates.expand(pr, (t.shape[0],) + pr.shape), t,
                         proto.bitsize, proto.max_bitsize)
    return cc.argmin_tree(be, _gather_lwe(dists, mesh, "dp"), _index_words(be, n_templates))


def _index_words(be, n_templates: int) -> lwe.Lwe:
    """Trivial encryptions of 0 .. n_templates-1, as Server.identify_argmin
    builds them."""
    ibits = max(1, (n_templates - 1).bit_length())
    return cc.const_word(be, np.arange(n_templates), ibits, (n_templates,))


def _argmin_local_then_global(be, vals: lwe.Lwe, idxs: lwe.Lwe, mesh):
    """Per-shard bootstrapped tournament, a gather of the dp finalists into
    a new leading axis, and the last rounds on every rank.  For power-of-two
    shards the comparison tree is argmin_tree's over the global axis."""
    v, i = cc.argmin_tree(be, vals, idxs)
    ga = [torch.stack(_gather(x, mesh, "dp")) for x in (v.a, v.b, i.a, i.b)]
    return cc.argmin_tree(be, lwe.Lwe(ga[0], ga[1]), lwe.Lwe(ga[2], ga[3]))


def sharded_argmin(mesh, ck: CloudKey, vals_ct: lwe.Lwe,
                   idxs_ct: lwe.Lwe) -> "tuple[lwe.Lwe, lwe.Lwe]":
    """Encrypted tournament argmin over dp-sharded (M, W)/(M, I) word lists:
    the cross-shard mechanism of `sharded_identify_argmin` on precomputed
    words.  Returns (min_val, min_idx) on every rank."""
    be = CipherBackend(slim_for_bootstrap(ck))
    return _argmin_local_then_global(be, shard_lwe(mesh, vals_ct, ("dp",)),
                                     shard_lwe(mesh, idxs_ct, ("dp",)), mesh)


def sharded_identify_argmin(mesh, ck: CloudKey, probe_ct: lwe.Lwe,
                            templates_ct: lwe.Lwe, bitsize: int,
                            max_bitsize: int) -> "tuple[lwe.Lwe, lwe.Lwe]":
    """Encrypted tournament argmin over a dp-sharded template database:
    per rank the distances to its N/dp templates and a local tournament
    carrying global index words; then the dp finalists (a distance word and
    an index word each) are gathered and the last log2(dp) rounds run on
    every rank.  For N = dp * 2^t the comparison tree, ties included (the
    lowest index wins), is the single-device argmin_tree's, so the result is
    bit-equal.  Returns (enc_min_dist (max_bitsize,), enc_idx (ibits,)).
    """
    n_templates = templates_ct.shape[0]
    _check_dp_templates(n_templates, mesh)
    be = CipherBackend(slim_for_bootstrap(ck))
    t = shard_lwe(mesh, templates_ct, ("dp",))
    idx = shard_lwe(mesh, _index_words(be, n_templates), ("dp",))
    probe_b = gates.expand(probe_ct, (t.shape[0],) + probe_ct.shape)
    dists = cc.euclidean(be, probe_b, t, bitsize, max_bitsize)
    return _argmin_local_then_global(be, dists, idx, mesh)
