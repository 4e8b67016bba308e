"""Device-resident condensed distance pipeline for large populations.

The CLI path (ops/distances.condensed_self_block) streams chunk rows back
to the host — right when artefacts must be written, but at 20k+ genomes
the full condensed matrix (1.7 GB at n=20480) has no business on the host
at all: every consumer (model subsample, lineage kNN, boundary sweep,
network edges) needs either O(n) or sparse data. This module keeps the
condensed matrix in HBM end to end and streams only O(n + E) results out
— the scale story the reference cannot tell (its refineFit hands the
whole host matrix to every scoring process, PopPUNK/refine.py:147-166).

Layout — the "folded" condensed buffer. Row chunks alone give ragged
upper-triangle slices (scatter-heavy); instead each device pass
computes two row blocks, rows [s, s+c) and their mirrors [n-s-c, n-s),
and folds row i with row i' = n-1-i into one fixed-width line of n-1
pairs:

    fold row r = i:   positions [0, n-1-i)   <- pairs (i, j), j = q+i+1
                      positions [n-1-i, n-1) <- pairs (i', j), j = q+1

so the buffer is a dense [n//2, n-1, 2] array written with pure
dynamic_update_slice (no scatter), holding each unordered pair exactly
once. fold_index/fold_inverse map (i < j) <-> flat positions. The same
pass top-ks every full row for lineage kNN, so the mirror block's
lower-triangle values are consumed, not wasted.

Consumers (all chunked over the buffer, nothing O(n^2) on the host):
  - subsample_pairs: random gather for model fitting (O(S));
  - kNN (fused in the fill pass): per-sample k nearest (O(n k));
  - sweep_first_offsets: the 1-D boundary sweep's (i, j, first-offset,
    d0) for pairs inside the widest boundary, computed on device and
    fetched sparse — the scale twin of
    ops/boundary.threshold_iterate_1d_fast, feeding the native sparse
    scorer (network/incremental.py) for every score index;
  - run_scale_pipeline: the full create-db -> fit -> network flow over a
    synthetic device population, with per-stage wall clock.
"""

import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .memory import memory_plan
from .ops.distances import core_accessory, corrected_jaccards, plane_geometry
from .ops.match_kernel import match_counts, use_kernel


class SweepSaturated(RuntimeError):
    """Sweep-geometry failure: the boundary search range is so wide that
    the in-boundary pair set exceeds the fetch/HBM caps (or spans every
    pair).  Retryable by shrinking max_move; distinct from XLA runtime
    RuntimeErrors (OOM etc.) which must propagate."""


class SweepFillOverflow(RuntimeError):
    """The subsample-estimated fill buffer under-sized the true
    in-boundary pair count.  Retryable by recounting exactly."""


def fold_rows(n):
    if n % 2:
        raise ValueError("folded condensed buffer requires even n")
    return n // 2


def fold_index(i, j, n):
    """Flat folded position of pair(s) i < j (host numpy)."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    first = i < n - 1 - i
    r = np.where(first, i, n - 1 - i)
    q = np.where(first, j - i - 1, j - 1)
    return r * (n - 1) + q


def fold_inverse(pos, n):
    """(i, j) of flat folded position(s) (host numpy)."""
    pos = np.asarray(pos, np.int64)
    r = pos // (n - 1)
    q = pos % (n - 1)
    first = q < n - 1 - r
    i = np.where(first, r, n - 1 - r)
    j = np.where(first, q + r + 1, q + 1)
    return i, j


def _fold_block(planes, lengths, freqs, s, c, klist, sketchsize64, bbits,
                pad_bits, knn, dist_col, use_pallas, n_real=None):
    """One fill step: distances for folded rows [s, s+c).

    planes is PLANE-MAJOR [K, P, n, W] (the resident layout, read in
    place by the bin-match kernel; see ops/match_kernel).
    Computes the 2c full rows (genomes s..s+c-1 and their mirrors
    n-s-c..n-s-1), folds their upper triangles into a [c, n-1, 2] block
    and top-ks every full row. Returns (folded, top_idx, top_d) with the
    kNN arrays ordered [low rows asc | mirror rows asc by genome id].

    n_real < n marks genomes >= n_real as PADDING (odd populations pad
    to even at pack time): their folded entries become +inf — excluded
    from boundary sweeps (searchsorted puts +inf past every offset) and
    masked out of the column maxima by the isinf check in
    _stream_stats_range — and they never enter any real row's kNN.
    """
    n = planes.shape[2]

    def rows(a, start, axis=0):
        return jax.lax.dynamic_slice_in_dim(a, start, c, axis=axis)

    pq = jnp.concatenate([rows(planes, s, 2), rows(planes, n - s - c, 2)],
                         axis=2)
    lq = jnp.concatenate([rows(lengths, s), rows(lengths, n - s - c)])
    fq = jnp.concatenate([rows(freqs, s), rows(freqs, n - s - c)],
                         axis=0)

    matches = match_counts(pq, planes, pad_bits, plane_major=True,
                           use_pallas=use_pallas)
    j = corrected_jaccards(matches, klist, lq, lengths, fq, freqs,
                           sketchsize64, bbits, True, True)
    d = core_accessory(j, klist)  # [2c, n, 2]

    i_vec = s + jnp.arange(c)  # global ids of the low block
    block_lo, block_hi = d[:c], d[c:]
    q = jnp.arange(n - 1)
    idx_lo = (q[None, :] + i_vec[:, None] + 1) % n  # [c, n-1]
    lo_part = jnp.take_along_axis(block_lo, idx_lo[..., None], axis=1)
    hi_rev = block_hi[::-1]  # row r of hi_rev = genome n-1-(s+r)
    first_len = (n - 1 - i_vec)[:, None]
    in_first = q[None, :] < first_len
    folded = jnp.where(in_first[..., None], lo_part, hi_rev[:, 1:, :])
    if n_real is not None and n_real < n:
        # position q of folded row i holds pair (i, q+i+1) in the first
        # segment, (n-1-i, q+1) in the second; the larger member is
        # q+i+1 / q+1 respectively, so it alone decides pad membership
        pad_pair = jnp.where(in_first,
                             q[None, :] + i_vec[:, None] + 1 >= n_real,
                             q[None, :] + 1 >= n_real)
        folded = jnp.where(pad_pair[..., None], jnp.inf, folded)

    # fused lineage kNN over the full rows. For small k, successive
    # min/argmin extractions instead of lax.top_k: the reduction
    # passes are cheap next to the match kernel, cheaper than top_k's
    # sort network. Past ~16 neighbours (e.g. the embedding pass's k=50) the k
    # sequential passes dominate and top_k wins. Results are identical:
    # both resolve ties to the lowest index.
    row_ids = jnp.concatenate([i_vec, n - s - c + jnp.arange(c)])
    col = d[..., dist_col]
    col = col.at[jnp.arange(2 * c), row_ids].set(jnp.inf)  # mask self
    if n_real is not None and n_real < n:
        col = col.at[:, n_real:].set(jnp.inf)  # pads never neighbours
    top_i, top_d = _seq_topk(col, knn)
    return folded, top_i, top_d


def _seq_topk(col, knn):
    """k smallest entries per row of ``col`` ordered by (value, index)
    ascending — ties resolve to the LOWEST index, matching lax.top_k.

    For small k, successive min/argmin extractions instead of lax.top_k:
    the reduction passes are cheap next to the match kernel, cheaper
    than top_k's sort network. Past ~16 neighbours the k sequential passes dominate and
    top_k wins. Returns (idx i32 [rows, k], dist f32 [rows, k])."""
    rows = col.shape[0]
    if knn > 16:
        neg_top, top_i = jax.lax.top_k(-col, knn)
        return top_i.astype(jnp.int32), -neg_top
    tops_d, tops_i = [], []
    for _ in range(knn):
        a = col.argmin(axis=1).astype(jnp.int32)
        tops_d.append(jnp.take_along_axis(col, a[:, None], axis=1)[:, 0])
        tops_i.append(a)
        col = col.at[jnp.arange(rows), a].set(jnp.inf)
    return jnp.stack(tops_i, axis=1), jnp.stack(tops_d, axis=1)


@partial(jax.jit, static_argnames=("c", "klist", "sketchsize64", "bbits",
                                   "pad_bits", "knn", "dist_col",
                                   "use_pallas"))
def _fill_all(planes, lengths, freqs, c, klist, sketchsize64, bbits,
              pad_bits, knn, dist_col, use_pallas):
    """All passes in ONE dispatch: lax.scan over row chunks.

    Each scan step computes rows [s, s+c) + their mirrors as full rows,
    folds the upper triangles into the condensed buffer and top-ks every
    row for the fused lineage kNN, in a single device program.
    """
    n = planes.shape[2]
    half = n // 2

    def step(carry, s):
        buf, knn_idx_buf, knn_d_buf = carry
        folded, top_idx, top_d = _fold_block(
            planes, lengths, freqs, s, c, klist, sketchsize64, bbits,
            pad_bits, knn, dist_col, use_pallas)
        buf = jax.lax.dynamic_update_slice(buf, folded, (s, 0, 0))
        knn_idx_buf = jax.lax.dynamic_update_slice(
            knn_idx_buf, top_idx[:c], (s, 0))
        knn_idx_buf = jax.lax.dynamic_update_slice(
            knn_idx_buf, top_idx[c:], (n - s - c, 0))
        knn_d_buf = jax.lax.dynamic_update_slice(
            knn_d_buf, top_d[:c], (s, 0))
        knn_d_buf = jax.lax.dynamic_update_slice(
            knn_d_buf, top_d[c:], (n - s - c, 0))
        return (buf, knn_idx_buf, knn_d_buf), None

    init = (jnp.zeros((half, n - 1, 2), jnp.float32),
            jnp.zeros((n, knn), jnp.int32),
            jnp.zeros((n, knn), jnp.float32))
    starts = jnp.arange(0, half, c, dtype=jnp.int32)
    (buf, knn_idx_buf, knn_d_buf), _ = jax.lax.scan(step, init, starts)
    return buf, knn_idx_buf, knn_d_buf


class CondensedDevice:
    """The folded condensed buffer plus its O(n) side products."""

    def __init__(self, buf, n, knn_row, knn_col, knn_dist):
        self.buf = buf  # [n//2, n-1, 2] f32, folded layout
        self.n = n
        self.n_pairs = n * (n - 1) // 2
        self.knn_row = knn_row
        self.knn_col = knn_col
        self.knn_dist = knn_dist

    def max_scale(self):
        """Column maxima over every pair (the model preprocessing scale)."""
        return np.asarray(jnp.max(self.buf, axis=(0, 1)))

    def subsample_pairs(self, size, seed=42):
        """Random pair subsample for model fitting — O(size) host."""
        rng = np.random.default_rng(seed)
        pos = rng.choice(self.n_pairs, size=min(size, self.n_pairs),
                         replace=False)
        flat = self.buf.reshape(-1, 2)
        return np.asarray(flat[jnp.asarray(np.sort(pos))])

    def knn_sparse(self):
        """(row, col, dist) grouped by row, each row's neighbours in
        ascending-distance order (like ops/sparse_knn.knn_from_condensed).
        knn_col/knn_dist are indexed by row id already."""
        n, k = self.knn_col.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), k)
        return rows, self.knn_col.ravel().astype(np.int64), \
            self.knn_dist.ravel()


def fill_condensed_device(planes, lengths, freqs, klist, sketchsize64,
                          bbits, chunk=512, knn=5, dist_col=0,
                          use_pallas=None, progress=None):
    """Compute all pairwise distances into a device condensed buffer.

    One pass over n//2 folded rows; each step computes 2*chunk full rows
    (upper triangles fill the buffer, full rows feed the fused kNN).
    """
    if use_pallas is None:
        use_pallas = use_kernel()
    n = planes.shape[2]
    half = fold_rows(n)
    chunk = min(chunk, half)
    if half % chunk:
        raise ValueError(f"n//2 ({half}) must be a multiple of chunk ({chunk})")
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    knn = min(knn, n - 1)

    buf, knn_idx_buf, knn_d_buf = _fill_all(
        jnp.asarray(planes), jnp.asarray(lengths), jnp.asarray(freqs),
        int(chunk), tuple(int(k) for k in klist), int(sketchsize64),
        int(bbits), int(pad_bits), int(knn), int(dist_col),
        bool(use_pallas))
    if progress:
        progress(half, half)
    knn_col = np.asarray(knn_idx_buf).astype(np.int64)
    knn_dist = np.asarray(knn_d_buf)
    return CondensedDevice(buf, n, np.arange(n, dtype=np.int64), knn_col,
                           knn_dist)


def fill_condensed_sharded(planes, lengths, freqs, klist, sketchsize64,
                           bbits, mesh=None, chunk=512, knn=5, dist_col=0,
                           use_pallas=None):
    """The sharded twin of fill_condensed_device: the folded condensed
    buffer lives row-sharded across every device of the mesh.

    Each device owns half/n_dev contiguous folded rows and runs the same
    lax.scan fill over its shard (sketch planes replicated — at the 50k
    tier they are ~5 GB vs the 10 GB buffer, so sharding the buffer is
    what unlocks the memory ceiling: per-device buffer drops to
    10 GB / n_dev while consumers keep streaming O(n + E)). The fused
    kNN is accumulated per-device in folded layout [half_loc, 2, k]
    (row i and its mirror n-1-i share a folded row) so every output
    shard is contiguous — no cross-device scatter. The reference has no
    analogue (single host matrix, PopPUNK/refine.py:147-166).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel.mesh import get_mesh

    if mesh is None:
        mesh = get_mesh()
    if use_pallas is None:
        use_pallas = use_kernel()
    n = planes.shape[2]
    half = fold_rows(n)
    n_dev = int(np.prod(list(mesh.shape.values())))
    r_size = mesh.shape["r"]
    if half % n_dev:
        raise ValueError(f"n//2 ({half}) must be a multiple of the device "
                         f"count ({n_dev})")
    half_loc = half // n_dev
    chunk = min(chunk, half_loc)
    if half_loc % chunk:
        raise ValueError(f"per-device rows ({half_loc}) must be a multiple "
                         f"of chunk ({chunk})")
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    knn = min(knn, n - 1)

    c = int(chunk)
    klist_t = tuple(int(k) for k in klist)

    def local_fill(planes, lengths, freqs):
        dev = jax.lax.axis_index("q") * r_size + jax.lax.axis_index("r")
        start0 = dev * half_loc

        def step(carry, s_loc):
            buf, ki, kd = carry
            folded, top_idx, top_d = _fold_block(
                planes, lengths, freqs, start0 + s_loc, c, klist_t,
                int(sketchsize64), int(bbits), int(pad_bits), knn,
                int(dist_col), bool(use_pallas))
            buf = jax.lax.dynamic_update_slice(buf, folded, (s_loc, 0, 0))
            # folded kNN layout: [:, 0] = low row s, [:, 1] = mirror
            # n-1-s. top_d[c:] row r is genome n-s-c+r -> folded row
            # s+c-1-r, hence the reversal.
            ki = jax.lax.dynamic_update_slice(
                ki, jnp.stack([top_idx[:c], top_idx[c:][::-1]], axis=1),
                (s_loc, 0, 0))
            kd = jax.lax.dynamic_update_slice(
                kd, jnp.stack([top_d[:c], top_d[c:][::-1]], axis=1),
                (s_loc, 0, 0))
            return (buf, ki, kd), None

        # carry becomes device-varying once start0 enters; mark the zero
        # init as varying over the mesh so scan's carry types match
        init = jax.lax.pcast(
            (jnp.zeros((half_loc, n - 1, 2), jnp.float32),
             jnp.zeros((half_loc, 2, knn), jnp.int32),
             jnp.zeros((half_loc, 2, knn), jnp.float32)),
            ("q", "r"), to="varying")
        starts = jnp.arange(0, half_loc, c, dtype=jnp.int32)
        (buf, ki, kd), _ = jax.lax.scan(step, init, starts)
        return buf, ki, kd

    fill = jax.jit(jax.shard_map(
        local_fill,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(("q", "r"), None, None), P(("q", "r"), None, None),
                   P(("q", "r"), None, None)), check_vma=False))
    rep = NamedSharding(mesh, P())
    with mesh:
        buf, ki, kd = fill(jax.device_put(jnp.asarray(planes), rep),
                           jax.device_put(jnp.asarray(lengths), rep),
                           jax.device_put(jnp.asarray(freqs), rep))

    # unfold the folded-layout kNN to per-genome rows (O(n k) host)
    ki_h = np.asarray(ki)
    kd_h = np.asarray(kd)
    knn_col = np.empty((n, knn), np.int64)
    knn_dist = np.empty((n, knn), np.float32)
    knn_col[:half] = ki_h[:, 0]
    knn_col[half:] = ki_h[::-1, 1]
    knn_dist[:half] = kd_h[:, 0]
    knn_dist[half:] = kd_h[::-1, 1]
    return CondensedDevice(buf, n, np.arange(n, dtype=np.int64), knn_col,
                           knn_dist)


# ---------------------------------------------------------------------------
# Streaming mode: NO O(n^2) tensor anywhere, at any n
#
# The folded buffer is 4 n^2 bytes of device memory (1.7 GB at n=20480,
# 17 GB at n=65536): past memory_plan().folded_buffer_max it is not kept
# resident. The reference hits the same wall earlier and
# harder — its refineFit hands the whole HOST condensed matrix to every
# scoring process (PopPUNK/refine.py:147-166). Streaming mode trades one
# extra distance pass per boundary sweep for O(n * sketch) total memory:
#   pass 1 (construction): the same scan as _fill_all, but the folded
#     chunk is reduced (fused kNN + column maxima + the pre-drawn model
#     subsample's pairs) and DISCARDED — the only O(n^2)-derived object
#     is the transient [chunk, n-1, 2] block inside a scan step;
#   pass 2 (per boundary sweep): a counts-only histogram pre-pass sees
#     every offset's density, then folded chunks are recomputed and
#     only in-boundary pairs for offsets under max_sweep_fetch cross to
#     the host (refine_fit_device).
# Both passes run as dispatches of bounded work, single-device or
# sharded row-ranges over the ('q','r') mesh (_ShardedStream).


# Full-row pair computations per device dispatch: both streaming passes
# split their scan into dispatches of bounded work.
PAIRS_PER_DISPATCH = 1.0e9


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "knn", "dist_col",
                                   "use_pallas", "n_real"),
         donate_argnums=(3, 4, 5))
def _stream_stats_range(planes, lengths, freqs, ki, kd, cmax, s0, c, steps,
                        sub_loc, klist, sketchsize64, bbits, pad_bits, knn,
                        dist_col, use_pallas, n_real=None):
    """Pass-1 slice: `steps` folded chunks from row s0, carries donated
    (kNN bufs + column maxima stay device-resident between dispatches).

    sub_loc i32[steps, M]: per-chunk flat positions (within the chunk's
    folded [c * (n-1)] block, padded with 0) of the model-subsample
    pairs drawn for this population — each chunk's sampled distances are
    gathered BEFORE the block is discarded and returned as [steps, M, 2].
    Gathering the sketches for sampled pairs after the fact instead
    (planes[:, :, ii, :]) makes XLA relayout-copy the whole planes
    tensor (a measured 9 GB `copy` OOM at n=65536)."""
    n = planes.shape[2]

    def step(carry, xs):
        s, loc = xs
        ki_buf, kd_buf, cm = carry
        folded, top_idx, top_d = _fold_block(
            planes, lengths, freqs, s, c, klist, sketchsize64, bbits,
            pad_bits, knn, dist_col, use_pallas, n_real)
        finite = jnp.where(jnp.isinf(folded), -jnp.inf, folded)
        cm = jnp.maximum(cm, finite.max(axis=(0, 1)))
        sub_vals = folded.reshape(-1, 2)[loc]
        ki_buf = jax.lax.dynamic_update_slice(ki_buf, top_idx[:c], (s, 0))
        ki_buf = jax.lax.dynamic_update_slice(ki_buf, top_idx[c:],
                                              (n - s - c, 0))
        kd_buf = jax.lax.dynamic_update_slice(kd_buf, top_d[:c], (s, 0))
        kd_buf = jax.lax.dynamic_update_slice(kd_buf, top_d[c:],
                                              (n - s - c, 0))
        return (ki_buf, kd_buf, cm), sub_vals

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    (ki, kd, cmax), sub_vals = jax.lax.scan(step, (ki, kd, cmax),
                                            (starts, sub_loc))
    return ki, kd, cmax, sub_vals


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "knn", "dist_col",
                                   "use_pallas", "slope", "n_real"),
         donate_argnums=(3, 4, 5, 6, 7, 8, 9))
def _stream_stats_fill_range(planes, lengths, freqs, ki, kd, cmax, bi, bj,
                             bd, acc, s0, n_act, scale, t, xm0, ym0, c,
                             steps, klist, sketchsize64, bbits, pad_bits,
                             knn, dist_col, use_pallas, slope, n_real=None):
    """Pass-1 slice FUSED with the boundary-band edge fill: each folded
    chunk feeds both the stats epilogue (kNN merge + column maxima,
    _stream_stats_range) and the direct-append fill epilogue
    (_stream_fill_group) before being discarded — the two-round
    bootstrap's single streaming pass, eliminating the refine fill's
    full distance recompute (206 s of the 255 s round-4 refine at 65k).

    The offset histogram is exact over the FULL threshold grid `t`
    (direct compare+reduce per offset) even though only pairs under
    t[n_act - 1] are stored, so the caller gets the counts pass for
    free. Pad pairs (n_real < n) fold to +inf and are excluded from
    both epilogues. No subsample gather arm: the bootstrap computes the
    model subsample directly before this pass runs.
    Returns (ki, kd, cmax, bi, bj, bd, acc, cum)."""
    n = planes.shape[2]
    cap = bi.shape[0]
    t_band = t[n_act - 1]

    def step(carry, s):
        ki_buf, kd_buf, cm, bi, bj, bd, acc, cum = carry
        folded, top_idx, top_d = _fold_block(
            planes, lengths, freqs, s, c, klist, sketchsize64, bbits,
            pad_bits, knn, dist_col, use_pallas, n_real)
        finite = jnp.where(jnp.isinf(folded), -jnp.inf, folded)
        cm = jnp.maximum(cm, finite.max(axis=(0, 1)))
        ki_buf = jax.lax.dynamic_update_slice(ki_buf, top_idx[:c], (s, 0))
        ki_buf = jax.lax.dynamic_update_slice(ki_buf, top_idx[c:],
                                              (n - s - c, 0))
        kd_buf = jax.lax.dynamic_update_slice(kd_buf, top_d[:c], (s, 0))
        kd_buf = jax.lax.dynamic_update_slice(kd_buf, top_d[c:],
                                              (n - s - c, 0))
        d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0, ym0, slope)
        cum = cum + jax.vmap(
            lambda tv: (d0 <= tv).sum(dtype=jnp.int32))(t)
        active = d0 <= t_band
        m = d0.shape[0]
        pos = jnp.arange(m, dtype=jnp.int32)
        dest = acc + jnp.cumsum(active.astype(jnp.int32)) - 1
        # dropped lanes get cap + lane: ALL destinations are genuinely
        # unique, so unique_indices=True is honest and XLA skips the
        # duplicate-resolution pass in the scatter lowering
        dest = jnp.where(active, dest, cap + pos)
        r = pos // (n - 1) + s
        q = pos % (n - 1)
        first = q < n - 1 - r
        gi = jnp.where(first, r, n - 1 - r)
        gj = jnp.where(first, q + r + 1, q + 1)
        bi = bi.at[dest].set(gi, mode="drop", unique_indices=True)
        bj = bj.at[dest].set(gj, mode="drop", unique_indices=True)
        bd = bd.at[dest].set(d0, mode="drop", unique_indices=True)
        acc = acc + active.sum(dtype=jnp.int32)
        return (ki_buf, kd_buf, cm, bi, bj, bd, acc, cum), None

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    cum0 = jnp.zeros(t.shape[0], jnp.int32)
    (ki, kd, cmax, bi, bj, bd, acc, cum), _ = jax.lax.scan(
        step, (ki, kd, cmax, bi, bj, bd, acc, cum0), starts)
    return ki, kd, cmax, bi, bj, bd, acc, cum


def _dispatch_plan(half, chunk, n, cap_rows=None):
    """Dispatch groups [(step_offset, n_steps)] covering the half//chunk
    scan steps, each computing <= PAIRS_PER_DISPATCH full-row pairs (and
    <= cap_rows rows, for passes with per-row output buffers). The tail
    group may be smaller — one extra compiled program at most, instead of
    degrading every dispatch to a divisor of an awkward step count."""
    n_steps = half // chunk
    rows_budget = max(chunk, int(PAIRS_PER_DISPATCH // (2 * n)))
    if cap_rows is not None:
        rows_budget = min(rows_budget, max(chunk, cap_rows))
    steps_pd = max(1, min(n_steps, rows_budget // chunk))
    return [(s, min(steps_pd, n_steps - s))
            for s in range(0, n_steps, steps_pd)]


def _pair_corrected_fit(matches, li, lj, fi, fj, klist, sketchsize64,
                        bbits):
    """[c, K] match counts + per-pair lengths/freqs -> f32[c, 2] dists.

    Each pair is corrected as its own 1x1 block (_random_jaccard_jnp
    broadcasts its length/freq args into a QxR cross matrix) — the ONE
    definition shared by _pair_block_dists and the column-sharded
    pair_dists gather so the two paths cannot drift."""
    def one(m_k, a, b, u, v):
        jac = corrected_jaccards(m_k[None, None], klist, a[None], b[None],
                                 u[None], v[None], sketchsize64, bbits,
                                 True, True)
        return jac[0, 0]

    jac = jax.vmap(one)(matches, li, lj, fi, fj)
    return core_accessory(jac, klist)  # [c, 2]


@partial(jax.jit, static_argnames=("klist", "sketchsize64", "bbits",
                                   "pad_bits"))
def _pair_block_dists(planes, lengths, freqs, ii, jj, klist, sketchsize64,
                      bbits, pad_bits):
    """Distances for an explicit pair list: i32[c] x i32[c] -> f32[c, 2].

    planes is plane-major [K, P, n, Wp]. Elementwise per-pair twin of
    the all-vs-all kernel (same plane AND-reduce + popcount; the
    correction and k-mer fit reuse the block functions via vmap so the
    math cannot drift). The sketch gather runs one k at a time: XLA
    lowers a gather along axis 2 via a relayout COPY of its operand, so
    gathering the whole tensor at once doubles planes in HBM (a
    measured 9 GB OOM at 65k) while the per-k transient is bounded at
    one k-slice."""
    def per_k(k_planes):  # [P, n, Wp]
        pi = k_planes[:, ii, :].astype(jnp.uint32)  # [P, c, Wp]
        pj = k_planes[:, jj, :].astype(jnp.uint32)
        agree = ~(pi ^ pj)
        allp = jax.lax.reduce(agree, jnp.uint32(0xFFFFFFFF),
                              jax.lax.bitwise_and,
                              dimensions=(0,))  # [c, Wp]
        return jax.lax.population_count(allp).astype(jnp.int32).sum(
            axis=-1) - pad_bits  # [c]

    matches = jax.lax.map(per_k, planes).T  # [c, K]
    return _pair_corrected_fit(matches, lengths[ii], lengths[jj],
                               freqs[ii], freqs[jj], klist, sketchsize64,
                               bbits)


class _ShardedStream:
    """jitted shard_map callables for the sharded streaming passes.

    Device d owns folded rows [d*half_loc, (d+1)*half_loc); every
    dispatch advances each device through `steps` of ITS chunks, so one
    dispatch covers n_dev * steps * c rows. kNN carries live sharded in
    the folded per-device layout of fill_condensed_sharded
    ([half, 2, k] row-sharded, updated in place across dispatches — no
    cross-device traffic at all); column maxima are per-device [1, 2]
    rows max-combined on the host at the end.
    """

    def __init__(self, mesh, half_loc, c, knn, klist, ss64, bbits,
                 pad_bits, dist_col, use_pallas, n_real=None):
        from jax.sharding import PartitionSpec as P

        self.mesh = mesh
        self.half_loc = half_loc
        self.c = c
        r_size = mesh.shape["r"]

        def dev_row0(off):
            dev = (jax.lax.axis_index("q") * r_size
                   + jax.lax.axis_index("r"))
            return dev * half_loc + off * c

        def fold(planes, lengths, freqs, s, k):
            return _fold_block(planes, lengths, freqs, s, c, klist, ss64,
                               bbits, pad_bits, k, dist_col, use_pallas,
                               n_real)

        def make_stats(fsteps):
            def stats_local(planes, lengths, freqs, ki, kd, cmax, off,
                            sub_loc):
                start0 = dev_row0(off)

                def step(carry, xs):
                    s_idx, loc = xs
                    ki, kd, cm = carry
                    folded, top_idx, top_d = fold(
                        planes, lengths, freqs, start0 + s_idx * c, knn)
                    finite = jnp.where(jnp.isinf(folded), -jnp.inf,
                                       folded)
                    cm = jnp.maximum(cm, finite.max(axis=(0, 1))[None])
                    sub_vals = folded.reshape(-1, 2)[loc]
                    row = (off + s_idx) * c  # shard-local offset
                    ki = jax.lax.dynamic_update_slice(
                        ki, jnp.stack([top_idx[:c], top_idx[c:][::-1]],
                                      axis=1), (row, 0, 0))
                    kd = jax.lax.dynamic_update_slice(
                        kd, jnp.stack([top_d[:c], top_d[c:][::-1]],
                                      axis=1), (row, 0, 0))
                    return (ki, kd, cm), sub_vals

                xs = (jnp.arange(fsteps, dtype=jnp.int32), sub_loc[0])
                (ki, kd, cmax), sub_vals = jax.lax.scan(
                    step, (ki, kd, cmax), xs)
                return ki, kd, cmax, sub_vals[None]

            return jax.jit(jax.shard_map(
                stats_local, mesh=mesh,
                in_specs=(rep, rep, rep, sh3, sh3, sh2, rep, sh3),
                out_specs=(sh3, sh3, sh2,
                           P(("q", "r"), None, None, None)), check_vma=False),
                donate_argnums=(3, 4, 5))

        rep = P()
        sh1 = P(("q", "r"))
        sh2 = P(("q", "r"), None)
        sh3 = P(("q", "r"), None, None)

        def make_counts(key):
            slope, fsteps = key

            def counts_local(planes, lengths, freqs, off, scale, t,
                             xm0, ym0):
                start0 = dev_row0(off)

                # int32 is safe per dispatch: the grouping bounds each
                # dispatch's pairs under PAIRS_PER_DISPATCH < 2^31; the
                # caller sums groups in int64 on the host
                def body(cum, s_idx):
                    folded, _, _ = fold(planes, lengths, freqs,
                                        start0 + s_idx * c, 1)
                    d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0,
                                   ym0, slope)
                    return cum + jax.vmap(
                        lambda tv: (d0 <= tv).sum(dtype=jnp.int32))(t), \
                        None

                # the body is device-varying (start0); mark the zero
                # init varying so scan's carry types match
                init = jax.lax.pcast(jnp.zeros(t.shape[0], jnp.int32),
                                     ("q", "r"), to="varying")
                cum, _ = jax.lax.scan(
                    body, init, jnp.arange(fsteps, dtype=jnp.int32))
                return cum[None]

            return jax.jit(jax.shard_map(
                counts_local, mesh=mesh,
                in_specs=(rep,) * 8, out_specs=sh2, check_vma=False))

        def make_fetch(key):
            slope, fsteps = key

            def fetch_local(planes, lengths, freqs, off, n_act, scale,
                            t, xm0, ym0):
                start0 = dev_row0(off)

                def body(_, s_idx):
                    folded, _, _ = fold(planes, lengths, freqs,
                                        start0 + s_idx * c, 1)
                    d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0,
                                   ym0, slope)
                    return None, d0

                _, d0 = jax.lax.scan(body, None,
                                     jnp.arange(fsteps, dtype=jnp.int32))
                d0 = d0.reshape(-1)
                idx = jnp.searchsorted(t, d0,
                                       side="left").astype(jnp.int32)
                active = idx < n_act
                m = d0.shape[0]
                pos = jnp.sort(jnp.where(
                    active, jnp.arange(m, dtype=jnp.int32), m))
                safe = jnp.clip(pos, 0, m - 1)
                return (pos[None], jnp.take(idx, safe)[None],
                        jnp.take(d0, safe)[None], active.sum()[None])

            return jax.jit(jax.shard_map(
                fetch_local, mesh=mesh,
                in_specs=(rep,) * 9, out_specs=(sh2, sh2, sh2, sh1), check_vma=False))

        def make_fill(key):
            """Sparse-sweep fill: like fetch, but the compacted pairs are
            DECODED to global (i, j) on device and appended into this
            device's shard of the edge buffers — nothing O(E) crosses the
            host link (the mesh arm of scale.sweep_fill_device)."""
            slope, fsteps = key

            def fill_local(planes, lengths, freqs, bi, bj, bd, acc, off,
                           n_act, scale, t, xm0, ym0):
                n = planes.shape[2]
                start0 = dev_row0(off)

                def body(_, s_idx):
                    folded, _, _ = fold(planes, lengths, freqs,
                                        start0 + s_idx * c, 1)
                    d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0,
                                   ym0, slope)
                    return None, d0

                _, d0 = jax.lax.scan(body, None,
                                     jnp.arange(fsteps, dtype=jnp.int32))
                d0 = d0.reshape(-1)
                idx = jnp.searchsorted(t, d0,
                                       side="left").astype(jnp.int32)
                active = idx < n_act
                m = d0.shape[0]
                pos = jnp.sort(jnp.where(
                    active, jnp.arange(m, dtype=jnp.int32), m))
                count = active.sum()
                hist = jnp.bincount(idx, length=t.shape[0] + 1)
                # decode the sorted flat positions (local to this
                # dispatch's row window) to global (i, j) — the same
                # fold_inverse arithmetic as _fill_append, with the
                # device's row origin folded into start0
                lane = jnp.arange(m, dtype=jnp.int32)
                mask = lane < count
                safe = jnp.clip(pos, 0, m - 1)
                r = safe // (n - 1) + start0
                q = safe % (n - 1)
                first = q < n - 1 - r
                gi = jnp.where(first, r, n - 1 - r)
                gj = jnp.where(first, q + r + 1, q + 1)
                d0s = jnp.take(d0, safe)
                cap = bi.shape[1]
                dest = jnp.where(mask, acc[0] + lane, cap)
                bi = bi.at[0, dest].set(jnp.where(mask, gi, n),
                                        mode="drop")
                bj = bj.at[0, dest].set(jnp.where(mask, gj, n),
                                        mode="drop")
                bd = bd.at[0, dest].set(jnp.where(mask, d0s, jnp.inf),
                                        mode="drop")
                return (bi, bj, bd, acc + count, hist[None],
                        count[None])

            return jax.jit(jax.shard_map(
                fill_local, mesh=mesh,
                in_specs=(rep, rep, rep, sh2, sh2, sh2, sh1) + (rep,) * 6,
                out_specs=(sh2, sh2, sh2, sh1, sh2, sh1),
                check_vma=False), donate_argnums=(3, 4, 5, 6))

        def make_counts2d(fsteps):
            def counts2d_local(planes, lengths, freqs, off, scale, xg,
                               yg):
                start0 = dev_row0(off)

                def body(cum, s_idx):
                    folded, _, _ = fold(planes, lengths, freqs,
                                        start0 + s_idx * c, 1)
                    Xs = folded.reshape(-1, 2) / scale
                    x, y = Xs[:, 0], Xs[:, 1]

                    def cell(xm, ym):
                        return _inside_2d(x, y, xm, ym).sum(
                            dtype=jnp.int32)

                    counts = jax.vmap(lambda ym: jax.vmap(
                        lambda xm: cell(xm, ym))(xg))(yg)
                    return cum + counts, None

                init = jax.lax.pcast(
                    jnp.zeros((yg.shape[0], xg.shape[0]), jnp.int32),
                    ("q", "r"), to="varying")
                cum, _ = jax.lax.scan(
                    body, init, jnp.arange(fsteps, dtype=jnp.int32))
                return cum[None]

            return jax.jit(jax.shard_map(
                counts2d_local, mesh=mesh,
                in_specs=(rep,) * 7, out_specs=sh3, check_vma=False))

        def make_fetch2d(fsteps):
            def fetch2d_local(planes, lengths, freqs, off, scale,
                              x_caps, yg):
                start0 = dev_row0(off)

                def body(_, s_idx):
                    folded, _, _ = fold(planes, lengths, freqs,
                                        start0 + s_idx * c, 1)
                    Xs = folded.reshape(-1, 2) / scale
                    x, y = Xs[:, 0], Xs[:, 1]

                    def in_row(xm, ym):
                        return _inside_2d(x, y, xm, ym) & (xm > 0)

                    inside = jax.vmap(in_row)(x_caps, yg).any(axis=0)
                    return None, (inside, x, y)

                _, (inside, x, y) = jax.lax.scan(
                    body, None, jnp.arange(fsteps, dtype=jnp.int32))
                inside = inside.reshape(-1)
                x = x.reshape(-1)
                y = y.reshape(-1)
                m = inside.shape[0]
                pos = jnp.sort(jnp.where(
                    inside, jnp.arange(m, dtype=jnp.int32), m))
                safe = jnp.clip(pos, 0, m - 1)
                return (pos[None], jnp.take(x, safe)[None],
                        jnp.take(y, safe)[None], inside.sum()[None])

            return jax.jit(jax.shard_map(
                fetch2d_local, mesh=mesh,
                in_specs=(rep,) * 7, out_specs=(sh2, sh2, sh2, sh1), check_vma=False))

        self._counts_cache = {}
        self._fetch_cache = {}
        self._stats_cache = {}
        self._fill_cache = {}
        self._make_counts = make_counts
        self._make_fetch = make_fetch
        self._make_counts2d = make_counts2d
        self._make_fetch2d = make_fetch2d
        self._make_stats = make_stats
        self._make_fill = make_fill

    def stats(self, fsteps):
        if fsteps not in self._stats_cache:
            self._stats_cache[fsteps] = self._make_stats(fsteps)
        return self._stats_cache[fsteps]

    def counts(self, slope, fsteps):
        key = (slope, fsteps)
        if key not in self._counts_cache:
            self._counts_cache[key] = self._make_counts(key)
        return self._counts_cache[key]

    def fetch(self, slope, fsteps):
        key = (slope, fsteps)
        if key not in self._fetch_cache:
            self._fetch_cache[key] = self._make_fetch(key)
        return self._fetch_cache[key]

    def fill(self, slope, fsteps):
        key = (slope, fsteps)
        if key not in self._fill_cache:
            self._fill_cache[key] = self._make_fill(key)
        return self._fill_cache[key]

    def counts2d(self, fsteps):
        key = ("2d", fsteps)
        if key not in self._counts_cache:
            self._counts_cache[key] = self._make_counts2d(fsteps)
        return self._counts_cache[key]

    def fetch2d(self, fsteps):
        key = ("2d", fsteps)
        if key not in self._fetch_cache:
            self._fetch_cache[key] = self._make_fetch2d(fsteps)
        return self._fetch_cache[key]


class _ColShardedStream:
    """Column-sharded streaming passes: device d owns genome (column)
    block [d*n_loc, (d+1)*n_loc) of the PLANES — the one tensor whose
    replicated residency caps the replicated mesh path (~14 GB at 128k
    genomes / production geometry; see streaming_hbm_accounting and
    memory_plan().replicated_planes_max). Every device walks ALL folded
    row chunks and computes its column slice of each chunk's distance tile.

    SPMD structure per chunk step:
      - the 2c chunk rows' planes are assembled from the column shards
        (masked per-k gather + psum — O(c) ICI traffic, the only
        collective besides the kNN merge);
      - the local tile d[2c, n_loc, 2] is computed with the same kernel
        + correction as _fold_block;
      - pair-coverage reductions (counts/fetch/subsample/column maxima)
        use the square-coordinate owned mask col > row (the folded chunk
        covers exactly the upper-triangle entries of its 2c rows), so no
        full-width buffer is ever materialised;
      - the fused kNN takes each device's k best (value, index) and
        merges them with a 2-key lax.sort — the same (value, index)
        order as the single-device sequential-argmin extraction, on
        distances that are allclose but not bit-equal (the n_loc-wide
        program may reassociate the correction epilogue), so ranks can
        swap at float-reassociation near-ties.

    Host-visible outputs mirror the SINGLE-device streaming layout
    (replicated [n, k] kNN buffers, [fsteps, M, 2] subsample values), so
    StreamingCondensed's post-processing is shared; fetch outputs come
    back in local square coordinates and are decoded host-side by
    sweep_first_offsets / sweep2d_fetch_streaming.
    """

    def __init__(self, mesh, n, n_loc, c, knn, klist, ss64, bbits,
                 pad_bits, dist_col, use_pallas, n_real=None):
        from jax.sharding import PartitionSpec as P

        self.mesh = mesh
        self.n_loc = n_loc
        self.c = c
        r_size = mesh.shape["r"]
        n_lim = n if n_real is None else n_real

        rep = P()
        sh1 = P(("q", "r"))
        sh2 = P(("q", "r"), None)
        sh3 = P(("q", "r"), None, None)
        shp = P(None, None, ("q", "r"), None)  # planes: genome axis

        def col0_of():
            dev = (jax.lax.axis_index("q") * r_size
                   + jax.lax.axis_index("r"))
            return dev * n_loc

        def gather_rows(planes_loc, col0, ids):
            """Assemble [K, P, 2c, Wp] chunk-row planes from the column
            shards: masked per-k gather (axis-2 gathers relayout-copy
            their operand, so one k-slice at a time bounds the
            transient) + psum (each row lives in exactly one shard)."""
            local = ids - col0
            ok = (local >= 0) & (local < n_loc)
            safe = jnp.clip(local, 0, n_loc - 1)

            def per_k(k_planes):  # [P, n_loc, Wp]
                g = k_planes[:, safe, :]
                return jnp.where(ok[None, :, None], g, 0)

            contrib = jax.lax.map(per_k, planes_loc)
            return jax.lax.psum(contrib, ("q", "r"))

        def tile(planes_loc, lengths, freqs, col0, s):
            """Local distance tile for folded chunk s: d [2c, n_loc, 2],
            plus the global row ids [2c] and column ids [n_loc]."""
            row_ids = jnp.concatenate([s + jnp.arange(c),
                                       n - s - c + jnp.arange(c)])
            pq = gather_rows(planes_loc, col0, row_ids)
            lq = lengths[row_ids]
            fq = freqs[row_ids]
            l_loc = jax.lax.dynamic_slice_in_dim(lengths, col0, n_loc)
            f_loc = jax.lax.dynamic_slice_in_dim(freqs, col0, n_loc,
                                                 axis=0)
            matches = match_counts(pq, planes_loc, pad_bits,
                                   plane_major=True, use_pallas=use_pallas)
            j = corrected_jaccards(matches, klist, lq, l_loc, fq, f_loc,
                                   ss64, bbits, True, True)
            d = core_accessory(j, klist)  # [2c, n_loc, 2]
            col_ids = col0 + jnp.arange(n_loc)
            return d, row_ids, col_ids

        def pair_mask(row_ids, col_ids):
            """Entries of the tile that ARE this chunk's condensed pairs
            (owned exactly once across chunks x devices): upper triangle,
            real genomes only."""
            return ((col_ids[None, :] > row_ids[:, None])
                    & (col_ids[None, :] < n_lim))

        def make_stats(fsteps):
            def stats_local(planes_loc, lengths, freqs, ki, kd, cmax,
                            off, sub_loc):
                col0 = col0_of()

                def step(carry, xs):
                    s_idx, loc = xs
                    ki, kd, cm = carry
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids)
                    # column maxima over owned pairs (pmax at the end)
                    cm = jnp.maximum(
                        cm, jnp.where(owned[..., None], d,
                                      -jnp.inf).max(axis=(0, 1)))
                    # subsample: decode each flat folded position to its
                    # (square row, global col); owner contributes, the
                    # host sums device partials
                    r_l = loc // (n - 1)
                    q = loc % (n - 1)
                    in_first = q < n - 1 - (s + r_l)
                    a_row = jnp.where(in_first, r_l, 2 * c - 1 - r_l)
                    b_col = jnp.where(in_first, q + s + r_l + 1, q + 1)
                    lcol = b_col - col0
                    own = (lcol >= 0) & (lcol < n_loc)
                    vals = d[a_row, jnp.clip(lcol, 0, n_loc - 1)]
                    sub_vals = jnp.where(own[:, None], vals, 0.0)
                    # fused kNN over the full rows: local k best by
                    # (value, global index), merged across shards
                    colv = d[..., dist_col]
                    self_m = col_ids[None, :] == row_ids[:, None]
                    bad = self_m | (col_ids >= n_lim)[None, :]
                    li, ld = _seq_topk(
                        jnp.where(bad, jnp.inf, colv), knn)
                    gi = (col0 + li).astype(jnp.int32)
                    cand_d = jax.lax.all_gather(
                        ld, ("q", "r"), axis=1, tiled=True)  # [2c, D*k]
                    cand_i = jax.lax.all_gather(
                        gi, ("q", "r"), axis=1, tiled=True)
                    sd, si = jax.lax.sort((cand_d, cand_i), num_keys=2,
                                          dimension=1)
                    top_i, top_d = si[:, :knn], sd[:, :knn]
                    ki = jax.lax.dynamic_update_slice(ki, top_i[:c],
                                                      (s, 0))
                    ki = jax.lax.dynamic_update_slice(ki, top_i[c:],
                                                      (n - s - c, 0))
                    kd = jax.lax.dynamic_update_slice(kd, top_d[:c],
                                                      (s, 0))
                    kd = jax.lax.dynamic_update_slice(kd, top_d[c:],
                                                      (n - s - c, 0))
                    return (ki, kd, cm), sub_vals

                xs = (jnp.arange(fsteps, dtype=jnp.int32), sub_loc)
                (ki, kd, cmax), sub_vals = jax.lax.scan(
                    step, (ki, kd, cmax), xs)
                cmax = jax.lax.pmax(cmax, ("q", "r"))
                return ki, kd, cmax, sub_vals[None]

            return jax.jit(jax.shard_map(
                stats_local, mesh=mesh,
                in_specs=(shp, rep, rep, rep, rep, rep, rep, rep),
                out_specs=(rep, rep, rep, sh3),
                check_vma=False), donate_argnums=(3, 4, 5))

        def make_counts(key):
            slope, fsteps = key

            def counts_local(planes_loc, lengths, freqs, off, scale, t,
                             xm0, ym0):
                col0 = col0_of()

                def body(cum, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    d0 = _d0_chunk(d.reshape(-1, 2), scale, xm0, ym0,
                                   slope)
                    return cum + jax.vmap(
                        lambda tv: ((d0 <= tv) & owned).sum(
                            dtype=jnp.int32))(t), None

                init = jax.lax.pcast(jnp.zeros(t.shape[0], jnp.int32),
                                     ("q", "r"), to="varying")
                cum, _ = jax.lax.scan(
                    body, init, jnp.arange(fsteps, dtype=jnp.int32))
                return cum[None]

            return jax.jit(jax.shard_map(
                counts_local, mesh=mesh,
                in_specs=(shp,) + (rep,) * 7, out_specs=sh2, check_vma=False))

        def make_fetch(key):
            slope, fsteps = key

            def fetch_local(planes_loc, lengths, freqs, off, n_act,
                            scale, t, xm0, ym0):
                col0 = col0_of()

                def body(_, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    d0 = _d0_chunk(d.reshape(-1, 2), scale, xm0, ym0,
                                   slope)
                    return None, (d0, owned)

                _, (d0, owned) = jax.lax.scan(
                    body, None, jnp.arange(fsteps, dtype=jnp.int32))
                d0 = d0.reshape(-1)
                owned = owned.reshape(-1)
                idx = jnp.searchsorted(t, d0,
                                       side="left").astype(jnp.int32)
                active = owned & (idx < n_act)
                m = d0.shape[0]
                pos = jnp.sort(jnp.where(
                    active, jnp.arange(m, dtype=jnp.int32), m))
                safe = jnp.clip(pos, 0, m - 1)
                return (pos[None], jnp.take(idx, safe)[None],
                        jnp.take(d0, safe)[None], active.sum()[None])

            return jax.jit(jax.shard_map(
                fetch_local, mesh=mesh,
                in_specs=(shp,) + (rep,) * 8,
                out_specs=(sh2, sh2, sh2, sh1), check_vma=False))

        def make_fill(key):
            """Sparse-sweep fill over the column shards: each device
            appends its OWNED in-boundary pairs — decoded to global
            (i, j) on device with the _col_decode arithmetic — into its
            shard of the edge buffers (the col-sharded arm of
            scale.sweep_fill_device)."""
            slope, fsteps = key

            def fill_local(planes_loc, lengths, freqs, bi, bj, bd, acc,
                           off, n_act, scale, t, xm0, ym0):
                col0 = col0_of()

                def body(_, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    d0 = _d0_chunk(d.reshape(-1, 2), scale, xm0, ym0,
                                   slope)
                    return None, (d0, owned)

                _, (d0, owned) = jax.lax.scan(
                    body, None, jnp.arange(fsteps, dtype=jnp.int32))
                d0 = d0.reshape(-1)
                owned = owned.reshape(-1)
                idx = jnp.searchsorted(t, d0,
                                       side="left").astype(jnp.int32)
                active = owned & (idx < n_act)
                m = d0.shape[0]
                pos = jnp.sort(jnp.where(
                    active, jnp.arange(m, dtype=jnp.int32), m))
                count = active.sum()
                hist = jnp.bincount(jnp.where(owned, idx, t.shape[0]),
                                    length=t.shape[0] + 1)
                # decode tile-flat positions ([fsteps, 2c, n_loc]
                # row-major) to global (i, j): the device arm of
                # _col_decode
                lane = jnp.arange(m, dtype=jnp.int32)
                mask = lane < count
                safe = jnp.clip(pos, 0, m - 1)
                s_idx2 = safe // (2 * c * n_loc)
                rem = safe % (2 * c * n_loc)
                a_row = rem // n_loc
                lcol = rem % n_loc
                srow = (off + s_idx2) * c
                gi = jnp.where(a_row < c, srow + a_row,
                               n - srow - c + (a_row - c))
                gj = col0 + lcol
                d0s = jnp.take(d0, safe)
                cap = bi.shape[1]
                dest = jnp.where(mask, acc[0] + lane, cap)
                bi = bi.at[0, dest].set(jnp.where(mask, gi, n),
                                        mode="drop")
                bj = bj.at[0, dest].set(jnp.where(mask, gj, n),
                                        mode="drop")
                bd = bd.at[0, dest].set(jnp.where(mask, d0s, jnp.inf),
                                        mode="drop")
                return (bi, bj, bd, acc + count, hist[None],
                        count[None])

            return jax.jit(jax.shard_map(
                fill_local, mesh=mesh,
                in_specs=(shp, rep, rep, sh2, sh2, sh2, sh1)
                + (rep,) * 6,
                out_specs=(sh2, sh2, sh2, sh1, sh2, sh1),
                check_vma=False), donate_argnums=(3, 4, 5, 6))

        def make_counts2d(fsteps):
            def counts2d_local(planes_loc, lengths, freqs, off, scale,
                               xg, yg):
                col0 = col0_of()

                def body(cum, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    Xs = d.reshape(-1, 2) / scale
                    x, y = Xs[:, 0], Xs[:, 1]

                    def cell(xm, ym):
                        return (_inside_2d(x, y, xm, ym) & owned).sum(
                            dtype=jnp.int32)

                    counts = jax.vmap(lambda ym: jax.vmap(
                        lambda xm: cell(xm, ym))(xg))(yg)
                    return cum + counts, None

                init = jax.lax.pcast(
                    jnp.zeros((yg.shape[0], xg.shape[0]), jnp.int32),
                    ("q", "r"), to="varying")
                cum, _ = jax.lax.scan(
                    body, init, jnp.arange(fsteps, dtype=jnp.int32))
                return cum[None]

            return jax.jit(jax.shard_map(
                counts2d_local, mesh=mesh,
                in_specs=(shp,) + (rep,) * 6, out_specs=sh3, check_vma=False))

        def make_fetch2d(fsteps):
            def fetch2d_local(planes_loc, lengths, freqs, off, scale,
                              x_caps, yg):
                col0 = col0_of()

                def body(_, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    Xs = d.reshape(-1, 2) / scale
                    x, y = Xs[:, 0], Xs[:, 1]

                    def in_row(xm, ym):
                        return _inside_2d(x, y, xm, ym) & (xm > 0)

                    inside = (jax.vmap(in_row)(x_caps, yg).any(axis=0)
                              & owned)
                    return None, (inside, x, y)

                _, (inside, x, y) = jax.lax.scan(
                    body, None, jnp.arange(fsteps, dtype=jnp.int32))
                inside = inside.reshape(-1)
                x = x.reshape(-1)
                y = y.reshape(-1)
                m = inside.shape[0]
                pos = jnp.sort(jnp.where(
                    inside, jnp.arange(m, dtype=jnp.int32), m))
                safe = jnp.clip(pos, 0, m - 1)
                return (pos[None], jnp.take(x, safe)[None],
                        jnp.take(y, safe)[None], inside.sum()[None])

            return jax.jit(jax.shard_map(
                fetch2d_local, mesh=mesh,
                in_specs=(shp,) + (rep,) * 6,
                out_specs=(sh2, sh2, sh2, sh1), check_vma=False))

        def make_pair_dists(m):
            def pairs_local(planes_loc, lengths, freqs, ii, jj):
                col0 = col0_of()
                pi = gather_rows(planes_loc, col0, ii)
                pj = gather_rows(planes_loc, col0, jj)

                def per_k(ops):
                    a, b = ops
                    agree = ~(a.astype(jnp.uint32) ^ b.astype(jnp.uint32))
                    allp = jax.lax.reduce(
                        agree, jnp.uint32(0xFFFFFFFF),
                        jax.lax.bitwise_and, dimensions=(0,))
                    return jax.lax.population_count(allp).astype(
                        jnp.int32).sum(axis=-1) - pad_bits

                matches = jax.lax.map(per_k, (pi, pj)).T  # [m, K]
                return _pair_corrected_fit(
                    matches, lengths[ii], lengths[jj], freqs[ii],
                    freqs[jj], klist, ss64, bbits)

            return jax.jit(jax.shard_map(
                pairs_local, mesh=mesh,
                in_specs=(shp,) + (rep,) * 4, out_specs=P(),
                check_vma=False))

        def make_compact(pair_fn, n_payload, fsteps):
            """Generic compaction over the column shards: pair_fn maps a
            tile's raw pairs f32[m, 2] to (mask, *payloads); each device
            compacts its owned entries. The _mesh_compact_pass twin for
            populations whose replicated planes would overflow HBM."""
            def local(planes_loc, lengths, freqs, off):
                col0 = col0_of()

                def body(_, s_idx):
                    s = (off + s_idx) * c
                    d, row_ids, col_ids = tile(planes_loc, lengths,
                                               freqs, col0, s)
                    owned = pair_mask(row_ids, col_ids).reshape(-1)
                    res = pair_fn(d.reshape(-1, 2))
                    return None, ((res[0] & owned),) + tuple(res[1:])

                _, outs = jax.lax.scan(
                    body, None, jnp.arange(fsteps, dtype=jnp.int32))
                keep = outs[0].reshape(-1)
                m = keep.shape[0]
                pos = jnp.sort(jnp.where(
                    keep, jnp.arange(m, dtype=jnp.int32), m))
                safe = jnp.clip(pos, 0, m - 1)
                return ((pos[None],)
                        + tuple(jnp.take(p.reshape(-1), safe)[None]
                                for p in outs[1:])
                        + (keep.sum()[None],))

            return jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(shp, rep, rep, rep),
                out_specs=(sh2,) * (1 + n_payload) + (sh1,),
                check_vma=False))

        self.make_compact = make_compact
        self._caches = {}
        self._makers = {"stats": make_stats, "counts": make_counts,
                        "fetch": make_fetch, "fill": make_fill,
                        "counts2d": make_counts2d,
                        "fetch2d": make_fetch2d,
                        "pairs": make_pair_dists}

    def _get(self, kind, key):
        if (kind, key) not in self._caches:
            self._caches[(kind, key)] = self._makers[kind](key)
        return self._caches[(kind, key)]

    def stats(self, fsteps):
        return self._get("stats", int(fsteps))

    def counts(self, slope, fsteps):
        return self._get("counts", (int(slope), int(fsteps)))

    def fetch(self, slope, fsteps):
        return self._get("fetch", (int(slope), int(fsteps)))

    def fill(self, slope, fsteps):
        return self._get("fill", (int(slope), int(fsteps)))

    def counts2d(self, fsteps):
        return self._get("counts2d", int(fsteps))

    def fetch2d(self, fsteps):
        return self._get("fetch2d", int(fsteps))

    def pair_dists(self, m):
        return self._get("pairs", int(m))


def streaming_hbm_accounting(n, klist, sketchsize64, bbits, chunk, knn,
                             n_dev, shard_planes=False):
    """Per-DEVICE resident + transient bytes for a streaming pass
    (StreamingCondensed) at the given geometry — the planning arithmetic
    behind the shard_planes auto-switch and the scale tests' asserted
    memory bounds.

    Returns a dict: planes (resident; replicated unless shard_planes),
    row_state (kNN buffers + maxima), transient (one chunk's tile +
    match counts), total."""
    from .ops.distances import plane_geometry

    _, wp, _ = plane_geometry(sketchsize64, bbits)
    K = len(klist)
    planes = K * bbits * n * wp * 4
    if shard_planes:
        planes = planes // n_dev
        width = -(-n // n_dev)  # local columns per tile
        knn_state = 2 * n * knn * 4  # replicated [n, k] idx + dist
    else:
        width = n
        knn_state = 2 * n * knn * 4 // n_dev  # row-sharded
    tile = 2 * chunk * width * 2 * 4  # d [2c, width, 2] f32
    matches = 2 * chunk * width * K * 4  # i32 counts
    rows = K * bbits * 2 * chunk * wp * 4 if shard_planes else 0
    return {
        "planes": planes,
        "row_state": knn_state + 2 * 4,
        "transient": tile + matches + rows,
        "total": planes + knn_state + tile + matches + rows,
    }


class StreamingCondensed:
    """CondensedDevice twin that never stores the condensed matrix.

    Exposes the same consumer surface (n, n_pairs, knn_col/knn_dist,
    max_scale, subsample_pairs, knn_sparse, sweep_first_offsets
    dispatch); `buf` stays None, which routes refine_fit_device to the
    sparse native scorer. Total device memory is planes + one transient
    chunk, so a device too small for the folded buffer (17 GB at 65k
    genomes) still holds the population.
    """

    buf = None

    def __init__(self, planes, lengths, freqs, klist, sketchsize64, bbits,
                 chunk=256, knn=5, dist_col=0, use_pallas=None,
                 subsample=None, mesh=None, n_real=None,
                 shard_planes=False, defer=False):
        if use_pallas is None:
            use_pallas = use_kernel()
        n = planes.shape[2]  # PADDED count (even); see n_real
        if n_real is None:
            n_real = n
        if not n_real <= n:
            raise ValueError(f"n_real ({n_real}) must be <= n ({n})")
        half = fold_rows(n)
        self._mesh = mesh
        shard_planes = _resolve_shard_planes(
            shard_planes, mesh, n, klist, sketchsize64, bbits, chunk, knn)
        self._col = bool(shard_planes) and mesh is not None
        if self._col:
            n_dev = int(np.prod(list(mesh.shape.values())))
            if n % n_dev:
                raise ValueError(f"n ({n}) must be a multiple of the "
                                 f"device count ({n_dev})")
            self._n_loc = n // n_dev
            self._n_dev = n_dev
            chunk = min(chunk, half)
            if half % chunk:
                raise ValueError(
                    f"n//2 ({half}) must be a multiple of chunk ({chunk})")
        elif mesh is not None:
            n_dev = int(np.prod(list(mesh.shape.values())))
            if half % n_dev:
                raise ValueError(f"n//2 ({half}) must be a multiple of "
                                 f"the device count ({n_dev})")
            self._half_loc = half // n_dev
            self._n_dev = n_dev
            chunk = min(chunk, self._half_loc)
            if self._half_loc % chunk:
                raise ValueError(f"per-device rows ({self._half_loc}) "
                                 f"must be a multiple of chunk ({chunk})")
        else:
            chunk = min(chunk, half)
            if half % chunk:
                raise ValueError(
                    f"n//2 ({half}) must be a multiple of chunk ({chunk})")
        self.planes = jnp.asarray(planes)
        self.lengths = jnp.asarray(lengths)
        self.freqs = jnp.asarray(freqs)
        self.n = int(n_real)
        self._n_pad = n
        self._n_real = int(n_real)
        self.n_pairs = n_real * (n_real - 1) // 2
        self.chunk = int(chunk)
        self._klist = tuple(int(k) for k in klist)
        self._ss64 = int(sketchsize64)
        self._bbits = int(bbits)
        _, _, pad_bits = plane_geometry(sketchsize64, bbits)
        self._pad_bits = int(pad_bits)
        self._use_pallas = bool(use_pallas)
        knn = min(knn, n_real - 1)
        self._knn_k = int(knn)
        self._dist_col = int(dist_col)
        self._prefill = None
        n_steps = half // self.chunk

        # pre-draw the model subsample so pass 1 can gather each chunk's
        # sampled pairs before discarding the block (see
        # _stream_stats_range); same rng stream as
        # CondensedDevice.subsample_pairs
        self._sub_spec = None
        block_pairs = self.chunk * (n - 1)
        if subsample is not None:
            size, sseed = subsample
            size = min(size, self.n_pairs)
            rng = np.random.default_rng(sseed)
            pos = np.sort(rng.choice(self.n_pairs, size=size,
                                     replace=False))
            if n_real < n:
                # padded layout: positions are drawn in REAL condensed
                # (i<j) indexing and mapped to the padded folded-flat
                # coordinates (pads are never drawn)
                from .pairs import condensed_to_pair

                ri, rj = condensed_to_pair(pos, n_real)
                flat = np.sort(fold_index(ri, rj, n))
            else:
                flat = pos  # folded-flat draw == CondensedDevice's
            g_of = flat // block_pairs
            counts = np.bincount(g_of, minlength=n_steps)
            M = max(8, int(counts.max()))
            loc = np.zeros((n_steps, M), np.int32)
            rank = np.arange(size) - np.concatenate(
                [[0], np.cumsum(counts)])[g_of]
            loc[g_of, rank] = (flat - g_of * block_pairs).astype(np.int32)
            self._sub_spec = (size, sseed, g_of, rank)
        else:
            M = 8
            loc = np.zeros((n_steps, M), np.int32)

        if defer:
            # two-round bootstrap: the caller computes the model
            # subsample directly (subsample_pairs), fits, then triggers
            # the single streaming pass — with the refine boundary-band
            # edge fill fused in — via run_pass1(fill_spec)
            if mesh is not None:
                raise ValueError(
                    "defer=True requires a single device (the bootstrap "
                    "pass runs the mesh tiers' standard pass 1)")
            self._deferred = True
            self._loc_np = loc
            return
        self._deferred = False

        if self._col:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # column-sharded: the PLANES (the tensor whose replicated
            # residency caps the replicated mesh path past ~100k genomes)
            # split over the genome axis; every device walks ALL folded
            # chunks and owns its column slice of each tile.
            # _plan_width: per-DEVICE tile width — the dispatch pair
            # budget (and the ~1-min program-kill bound it encodes)
            # applies to each device's n_loc-wide slice, so budgeting at
            # full width would split n_dev x too many dispatches
            self._plan_rows = half
            self._plan_width = self._n_loc
            self._sh = _ColShardedStream(
                mesh, n, self._n_loc, self.chunk, knn, self._klist,
                self._ss64, self._bbits, self._pad_bits, int(dist_col),
                self._use_pallas,
                int(n_real) if n_real < n else None)
            rep = NamedSharding(mesh, P())
            shp = NamedSharding(mesh, P(None, None, ("q", "r"), None))
            with mesh:
                self.planes = jax.device_put(self.planes, shp)
                self.lengths = jax.device_put(self.lengths, rep)
                self.freqs = jax.device_put(self.freqs, rep)
                ki = jax.device_put(jnp.zeros((n, knn), jnp.int32), rep)
                kd = jax.device_put(jnp.zeros((n, knn), jnp.float32),
                                    rep)
                cmax = jax.device_put(
                    jnp.full((2,), -jnp.inf, jnp.float32), rep)
                sub_parts = []
                for off, fsteps in _dispatch_plan(half, self.chunk,
                                                  self._plan_width):
                    sub_slice = jax.device_put(
                        jnp.asarray(loc[off:off + fsteps]), rep)
                    ki, kd, cmax, sv = self._sh.stats(int(fsteps))(
                        self.planes, self.lengths, self.freqs, ki, kd,
                        cmax, jnp.int32(off), sub_slice)
                    # each sampled pair is owned by exactly ONE device's
                    # column shard; the rest contributed zeros
                    sub_parts.append(np.asarray(sv).sum(axis=0))
            if self._sub_spec is not None:
                size, sseed, g_of, rank = self._sub_spec
                sub_vals = np.concatenate(sub_parts)  # [n_steps, M, 2]
                self._sub_vals = sub_vals[g_of, rank]
            self.knn_row = np.arange(n_real, dtype=np.int64)
            self.knn_col = np.asarray(ki).astype(np.int64)[:n_real]
            self.knn_dist = np.asarray(kd)[:n_real]
            self._cmax = np.asarray(cmax)
            return
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = self._n_dev
            self._plan_rows = self._half_loc
            self._plan_width = n
            spc = self._half_loc // self.chunk
            plan = _dispatch_plan(self._half_loc, self.chunk, n)
            self._sh = _ShardedStream(
                mesh, self._half_loc, self.chunk, knn,
                self._klist, self._ss64, self._bbits, self._pad_bits,
                int(dist_col), self._use_pallas,
                int(n_real) if n_real < n else None)
            rep = NamedSharding(mesh, P())
            sh2 = NamedSharding(mesh, P(("q", "r"), None))
            sh3 = NamedSharding(mesh, P(("q", "r"), None, None))
            with mesh:
                self.planes = jax.device_put(self.planes, rep)
                self.lengths = jax.device_put(self.lengths, rep)
                self.freqs = jax.device_put(self.freqs, rep)
                ki = jax.device_put(jnp.zeros((half, 2, knn), jnp.int32),
                                    sh3)
                kd = jax.device_put(
                    jnp.zeros((half, 2, knn), jnp.float32), sh3)
                cmax = jax.device_put(
                    jnp.full((n_dev, 2), -jnp.inf, jnp.float32), sh2)
                # chunk (d, off, s) of device d = global chunk
                # d * spc + off + s (shards are contiguous rows)
                loc_resh = loc.reshape(n_dev, spc, M)
                sub_parts = []
                for off, fsteps in plan:
                    sub_slice = jax.device_put(
                        jnp.asarray(np.ascontiguousarray(
                            loc_resh[:, off:off + fsteps])),
                        sh3)
                    ki, kd, cmax, sv = self._sh.stats(int(fsteps))(
                        self.planes, self.lengths, self.freqs, ki, kd,
                        cmax, jnp.int32(off), sub_slice)
                    sub_parts.append((off, fsteps, np.asarray(sv)))
            if self._sub_spec is not None:
                size, sseed, g_of, rank = self._sub_spec
                sub_vals = np.empty((n_steps, M, 2), np.float32)
                for off, fsteps, sv in sub_parts:
                    idxs = (np.arange(n_dev)[:, None] * spc
                            + off + np.arange(fsteps)[None, :])
                    sub_vals[idxs.reshape(-1)] = sv.reshape(-1, M, 2)
                self._sub_vals = sub_vals[g_of, rank]
            # unfold the folded-layout kNN (fill_condensed_sharded twin);
            # pad genomes' own rows (ids >= n_real) are dropped
            ki_h = np.asarray(ki)
            kd_h = np.asarray(kd)
            knn_col = np.empty((n, knn), np.int64)
            knn_dist = np.empty((n, knn), np.float32)
            knn_col[:half] = ki_h[:, 0]
            knn_col[half:] = ki_h[::-1, 1]
            knn_dist[:half] = kd_h[:, 0]
            knn_dist[half:] = kd_h[::-1, 1]
            self.knn_col = knn_col[:n_real]
            self.knn_dist = knn_dist[:n_real]
            self.knn_row = np.arange(n_real, dtype=np.int64)
            self._cmax = np.asarray(cmax).max(axis=0)
            return

        self._pass1_single(loc)

    def run_pass1(self, fill_spec=None):
        """Execute the deferred pass 1 (see __init__(defer=True)).

        fill_spec (from plan_sweep_band) fuses the refine sweep's
        in-boundary edge fill into the same chunk walk: dict(scale,
        offsets, slope, line, n_act, e_total). On buffer overflow the
        stats results are KEPT (dropped scatters don't corrupt them) and
        the prefill is discarded — refine_fit_device then refills
        exactly, as if no bootstrap ran."""
        if not self._deferred:
            raise RuntimeError("pass 1 already ran")
        self._pass1_single(self._loc_np, fill_spec)
        self._deferred = False
        del self._loc_np

    def _pass1_single(self, loc, fill_spec=None):
        """Single-device pass 1: stats (fused kNN + column maxima +
        predeclared-subsample gather), optionally fused with the
        boundary-band edge fill (_stream_stats_fill_range)."""
        n = self._n_pad
        half = fold_rows(n)
        knn = self._knn_k
        nr = self._n_real if self._n_real < n else None
        ki = jnp.zeros((n, knn), jnp.int32)
        kd = jnp.zeros((n, knn), jnp.float32)
        cmax = jnp.full((2,), -jnp.inf, jnp.float32)
        if fill_spec is not None:
            from .ops.sparse_sweep import SweepEdges, _bucket as _ss_bucket

            # the bootstrap computes the model subsample directly; any
            # predeclared gather spec is void (the fused kernel has no
            # gather arm)
            self._sub_spec = None
            xm0, ym0, t = _line_d0_params(
                fill_spec["offsets"], fill_spec["slope"],
                *fill_spec["line"])
            e_est = max(int(fill_spec["e_total"]), 1)
            e_alloc = _ss_bucket(e_est + max(1024, e_est // 128))
            bi = jnp.full(e_alloc, n, jnp.int32)
            bj = jnp.full(e_alloc, n, jnp.int32)
            bd = jnp.full(e_alloc, jnp.inf, jnp.float32)
            acc = jnp.int32(0)
            scale_dev = jnp.asarray(fill_spec["scale"], jnp.float32)
            t_dev = jnp.asarray(t, jnp.float32)
            cum64 = np.zeros(len(t), np.int64)
            pending = None
            for off, fsteps in _dispatch_plan(half, self.chunk, n):
                ki, kd, cmax, bi, bj, bd, acc, cum = \
                    _stream_stats_fill_range(
                        self.planes, self.lengths, self.freqs, ki, kd,
                        cmax, bi, bj, bd, acc,
                        jnp.int32(off * self.chunk),
                        jnp.int32(fill_spec["n_act"]), scale_dev, t_dev,
                        jnp.float32(xm0), jnp.float32(ym0), self.chunk,
                        int(fsteps), self._klist, self._ss64,
                        self._bbits, self._pad_bits, knn, self._dist_col,
                        self._use_pallas, int(fill_spec["slope"]), nr)
                if pending is not None:
                    cum64 += np.asarray(pending, np.int64)
                pending = cum
            if pending is not None:
                cum64 += np.asarray(pending, np.int64)
            acc_h = int(acc)
            if acc_h > e_alloc:
                sys.stderr.write(
                    f"bootstrap fill overflow: {acc_h} pairs > buffer "
                    f"{e_alloc} (estimated {e_est}); refine will refill "
                    "exactly\n")
                self._prefill = None
            else:
                self._prefill = (
                    SweepEdges(bi, bj, bd, acc_h, n,
                               n_real=self._n_real),
                    cum64, dict(fill_spec))
        else:
            loc_dev = jnp.asarray(loc)
            sub_parts = []
            for off, fsteps in _dispatch_plan(half, self.chunk, n):
                ki, kd, cmax, sv = _stream_stats_range(
                    self.planes, self.lengths, self.freqs, ki, kd, cmax,
                    jnp.int32(off * self.chunk), self.chunk,
                    int(fsteps),
                    jax.lax.dynamic_slice_in_dim(loc_dev, off, fsteps,
                                                 axis=0),
                    self._klist, self._ss64, self._bbits,
                    self._pad_bits, int(knn), self._dist_col,
                    self._use_pallas, nr)
                sub_parts.append(np.asarray(sv))
            if self._sub_spec is not None:
                size, sseed, g_of, rank = self._sub_spec
                sub_vals = np.concatenate(sub_parts)  # [n_steps, M, 2]
                self._sub_vals = sub_vals[g_of, rank]
        n_real = self._n_real
        self.knn_row = np.arange(n_real, dtype=np.int64)
        self.knn_col = np.asarray(ki).astype(np.int64)[:n_real]
        self.knn_dist = np.asarray(kd)[:n_real]
        self._cmax = np.asarray(cmax)

    def max_scale(self):
        """Column maxima over every pair (accumulated in pass 1)."""
        return self._cmax

    def subsample_pairs(self, size, seed=42, block=8192):
        """Same draw as CondensedDevice.subsample_pairs. If the (size,
        seed) spec was declared at construction the values were gathered
        during pass 1 (no extra compute, bit-identical to the buffered
        fill); otherwise the drawn pairs are recomputed directly —
        O(size), but the sketch gather forces an extra planes copy in
        HBM, so predeclare at large n."""
        if (self._sub_spec is not None
                and (min(size, self.n_pairs), seed) == self._sub_spec[:2]):
            return self._sub_vals.copy()
        rng = np.random.default_rng(seed)
        pos = np.sort(rng.choice(self.n_pairs,
                                 size=min(size, self.n_pairs),
                                 replace=False))
        if self._n_pad > self._n_real:
            from .pairs import condensed_to_pair

            i, j = condensed_to_pair(pos, self.n)
            i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
            # the predeclared gather returns rows in folded-flat order
            # (fold_index-sorted); match it so both paths feed model
            # fits identically-ordered samples
            order = np.argsort(fold_index(i, j, self._n_pad),
                               kind="stable")
            i, j = i[order], j[order]
        else:
            i, j = fold_inverse(pos, self.n)
        m = len(pos)
        pad = (-m) % block
        if pad:  # fixed block shape: one compiled program
            i = np.concatenate([i, np.zeros(pad, np.int64)])
            j = np.concatenate([j, np.ones(pad, np.int64)])
        if self._col:
            # planes are genome-sharded: gather each pair's rows from
            # the column shards instead of a replicated-plane gather
            fn = self._sh.pair_dists(block)
            out = [np.asarray(fn(
                self.planes, self.lengths, self.freqs,
                jnp.asarray(i[s:s + block], jnp.int32),
                jnp.asarray(j[s:s + block], jnp.int32)))
                for s in range(0, m + pad, block)]
            return np.concatenate(out)[:m]
        out = [np.asarray(_pair_block_dists(
            self.planes, self.lengths, self.freqs,
            jnp.asarray(i[s:s + block], jnp.int32),
            jnp.asarray(j[s:s + block], jnp.int32),
            self._klist, self._ss64, self._bbits, self._pad_bits))
            for s in range(0, m + pad, block)]
        return np.concatenate(out)[:m]

    def knn_sparse(self):
        """Same layout as CondensedDevice.knn_sparse."""
        n, k = self.knn_col.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), k)
        return rows, self.knn_col.ravel().astype(np.int64), \
            self.knn_dist.ravel()

    def pop_prefill(self):
        """Hand over the bootstrap prefill (edges, cum, spec), clearing
        this object's reference — so refine_fit_device's rare widen
        refill can actually free the band buffers before allocating the
        wider set. Returns None if no prefill exists (not bootstrapped,
        overflowed, or already popped)."""
        pf, self._prefill = self._prefill, None
        return pf


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "slope",
                                   "use_pallas", "n_real"))
def _stream_sweep_group(planes, lengths, freqs, s0, n_act, scale, t, xm0,
                        ym0, c, steps, klist, sketchsize64, bbits, pad_bits,
                        slope, use_pallas, n_real=None):
    """Pass-2 dispatch: recompute `steps` folded chunks from row s0 and
    compact their in-boundary pairs into ONE sorted bucket (the kNN arm
    of _fold_block is dead code here, DCE'd). Only pairs whose first
    offset is < n_act (traced, so no recompile per cap) are gathered.
    Returns (pos, idx, d0, count) with pos flat within the dispatch's
    row range."""

    def body(_, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0, ym0, slope)
        idx = jnp.searchsorted(t, d0, side="left").astype(jnp.int32)
        return None, (d0, idx)

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    _, (d0, idx) = jax.lax.scan(body, None, starts)
    d0 = d0.reshape(-1)
    idx = idx.reshape(-1)
    active = idx < n_act
    m = d0.shape[0]
    pos = jnp.sort(jnp.where(active, jnp.arange(m, dtype=jnp.int32), m))
    safe = jnp.clip(pos, 0, m - 1)
    # full first-offset histogram rides along for free (last bin =
    # outside the widest offset), so fill callers skip the separate
    # counts pre-pass
    hist = jnp.bincount(idx, length=t.shape[0] + 1)
    return pos, jnp.take(idx, safe), jnp.take(d0, safe), active.sum(), hist


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "slope",
                                   "use_pallas", "n_real"))
def _stream_sweep_counts(planes, lengths, freqs, s0, scale, t, xm0, ym0, c,
                         steps, klist, sketchsize64, bbits, pad_bits, slope,
                         use_pallas, n_real=None):
    """Histogram pass: cumulative in-boundary pair counts per offset for
    `steps` chunks from row s0 — O(n_grid) ints fetched, NO pair lists.
    Lets the sweep see each offset's density before deciding what to
    fetch (the reference materialises every in-boundary tuple host-side
    first, PopPUNK/refine.py:197-202 — at 65k genomes the widest offsets
    hold ~1e9 pairs and that fetch is the memory cliff)."""

    def body(_, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0, ym0, slope)
        cum = jax.vmap(lambda tv: (d0 <= tv).sum(dtype=jnp.int32))(t)
        return None, cum

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    _, cums = jax.lax.scan(body, None, starts)
    return cums  # [steps, n_grid] i32, summed in int64 on the host


# ---------------------------------------------------------------------------
# 2-D (unconstrained) streaming sweep
#
# The unconstrained search scores a 20x20 grid of (x_max, y_max)
# boundaries (PopPUNK/refine.py:116-166 — the reference farms y rows to a
# process pool over the full HOST matrix). Streaming twin: boundaries
# nest in both axes (inside at (xm, ym) => inside at any larger pair), so
# one counts pass sees every cell's density and ONE fetch pass gathers
# each in-union pair's scaled (x, y) coordinates; per-cell membership and
# first-x-offsets are then host arithmetic over the O(E) fetched pairs.


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "use_pallas",
                                   "n_real"))
def _stream_sweep2d_counts(planes, lengths, freqs, s0, scale, xg, yg, c,
                           steps, klist, sketchsize64, bbits, pad_bits,
                           use_pallas, n_real=None):
    """In-boundary pair counts for every (y, x) grid cell over `steps`
    folded chunks from row s0. Returns i32[ny, nx] (summed in int64 on
    the host across dispatches)."""

    def body(cum, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        Xs = folded.reshape(-1, 2) / scale
        x, y = Xs[:, 0], Xs[:, 1]

        def cell(xm, ym):
            return _inside_2d(x, y, xm, ym).sum(dtype=jnp.int32)

        counts = jax.vmap(lambda ym: jax.vmap(
            lambda xm: cell(xm, ym))(xg))(yg)
        return cum + counts, None

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    init = jnp.zeros((yg.shape[0], xg.shape[0]), jnp.int32)
    cum, _ = jax.lax.scan(body, init, starts)
    return cum


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "use_pallas",
                                   "n_real"))
def _stream_sweep2d_fetch(planes, lengths, freqs, s0, scale, x_caps, yg, c,
                          steps, klist, sketchsize64, bbits, pad_bits,
                          use_pallas, n_real=None):
    """Compact the pairs inside the UNION of per-row cap boundaries
    (x_caps[r] = widest scoreable x_max of row r, <= 0 disables the row)
    into one sorted bucket, returning their flat positions and scaled
    coordinates. Mirrors _stream_sweep_group's compaction."""

    def body(_, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        Xs = folded.reshape(-1, 2) / scale
        x, y = Xs[:, 0], Xs[:, 1]

        def in_row(xm, ym):
            return _inside_2d(x, y, xm, ym) & (xm > 0)

        inside = jax.vmap(in_row)(x_caps, yg).any(axis=0)
        return None, (inside, x, y)

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    _, (inside, x, y) = jax.lax.scan(body, None, starts)
    inside = inside.reshape(-1)
    x = x.reshape(-1)
    y = y.reshape(-1)
    m = inside.shape[0]
    pos = jnp.sort(jnp.where(inside, jnp.arange(m, dtype=jnp.int32), m))
    safe = jnp.clip(pos, 0, m - 1)
    return (pos, jnp.take(x, safe), jnp.take(y, safe), inside.sum())


def sweep2d_counts_streaming(cd, scale, x_grid, y_grid):
    """Exact int64 in-boundary pair counts for every (y, x) cell."""
    xg = jnp.asarray(x_grid, jnp.float32)
    yg = jnp.asarray(y_grid, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    n_pad = cd._n_pad
    cum = np.zeros((len(y_grid), len(x_grid)), np.int64)
    if cd._mesh is not None:
        for off, fsteps in _dispatch_plan(cd._plan_rows, cd.chunk,
                                          cd._plan_width):
            fn = cd._sh.counts2d(int(fsteps))
            cums = fn(cd.planes, cd.lengths, cd.freqs, jnp.int32(off),
                      scale_dev, xg, yg)
            cum += np.asarray(cums, np.int64).sum(axis=0)
        return cum
    half = fold_rows(n_pad)
    nr = cd._n_real if cd._n_real < n_pad else None
    for off, fsteps in _dispatch_plan(half, cd.chunk, n_pad):
        cum += np.asarray(_stream_sweep2d_counts(
            cd.planes, cd.lengths, cd.freqs,
            jnp.int32(off * cd.chunk), scale_dev, xg, yg,
            cd.chunk, int(fsteps), cd._klist, cd._ss64, cd._bbits,
            cd._pad_bits, cd._use_pallas, nr), np.int64)
    return cum


def sweep2d_fetch_streaming(cd, scale, x_caps, y_grid):
    """(i, j, x_scaled, y_scaled) for pairs inside the union of per-row
    cap boundaries — the O(E) host working set of the 2-D sweep."""
    xc = jnp.asarray(x_caps, jnp.float32)
    yg = jnp.asarray(y_grid, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    n_pad = cd._n_pad
    if getattr(cd, "_col", False):
        plan = _dispatch_plan(fold_rows(n_pad), cd.chunk, cd._plan_width,
                              cap_rows=int(1.5e9 / (26 * cd._n_loc)))
        i_out, j_out, x_out, y_out = [], [], [], []
        for off, fsteps in plan:
            fn = cd._sh.fetch2d(int(fsteps))
            m_loc = fsteps * 2 * cd.chunk * cd._n_loc
            pos, xs, ys, counts = fn(cd.planes, cd.lengths, cd.freqs,
                                     jnp.int32(off), scale_dev, xc, yg)
            counts_h = np.asarray(counts)
            for d in range(cd._n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                i, j = _col_decode(np.asarray(pos[d, :b][:k], np.int64),
                                   off, cd.chunk, cd._n_loc, n_pad, d)
                i_out.append(i)
                j_out.append(j)
                x_out.append(np.asarray(xs[d, :b][:k], np.float32))
                y_out.append(np.asarray(ys[d, :b][:k], np.float32))
        if not i_out:
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.float32), np.zeros(0, np.float32)
        return (np.concatenate(i_out), np.concatenate(j_out),
                np.concatenate(x_out), np.concatenate(y_out))
    if cd._mesh is not None:
        # sharded fetch: reassembled in (device, group) order =
        # ascending global rows, matching the single-device path
        plan = _dispatch_plan(cd._half_loc, cd.chunk, n_pad,
                              cap_rows=int(1.5e9 / (13 * n_pad)))
        parts = {}
        for gi, (off, fsteps) in enumerate(plan):
            fn = cd._sh.fetch2d(int(fsteps))
            m_loc = fsteps * cd.chunk * (n_pad - 1)
            pos, xs, ys, counts = fn(cd.planes, cd.lengths, cd.freqs,
                                     jnp.int32(off), scale_dev, xc, yg)
            counts_h = np.asarray(counts)
            for d in range(cd._n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                base = (d * cd._half_loc
                        + off * cd.chunk) * (n_pad - 1)
                parts[(d, gi)] = (
                    np.asarray(pos[d, :b][:k], np.int64) + base,
                    np.asarray(xs[d, :b][:k], np.float32),
                    np.asarray(ys[d, :b][:k], np.float32))
        pos_out, x_out, y_out = [], [], []
        for d in range(cd._n_dev):
            for gi in range(len(plan)):
                if (d, gi) in parts:
                    p, xv, yv = parts[(d, gi)]
                    pos_out.append(p)
                    x_out.append(xv)
                    y_out.append(yv)
        if not pos_out:
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.float32), np.zeros(0, np.float32)
        pos = np.concatenate(pos_out)
        i, j = fold_inverse(pos, n_pad)
        return (i.astype(np.int32), j.astype(np.int32),
                np.concatenate(x_out), np.concatenate(y_out))
    half = fold_rows(n_pad)
    nr = cd._n_real if cd._n_real < n_pad else None
    pos_out, x_out, y_out = [], [], []
    for off, fsteps in _dispatch_plan(half, cd.chunk, n_pad,
                                      cap_rows=int(1.5e9 / (13 * n_pad))):
        s0 = off * cd.chunk
        pos, xs, ys, count = _stream_sweep2d_fetch(
            cd.planes, cd.lengths, cd.freqs, jnp.int32(s0), scale_dev,
            xc, yg, cd.chunk, int(fsteps), cd._klist, cd._ss64,
            cd._bbits, cd._pad_bits, cd._use_pallas, nr)
        k = int(count)
        if k == 0:
            continue
        m = fsteps * cd.chunk * (n_pad - 1)
        b = min(_bucket_pow2(k), m)
        base = s0 * (n_pad - 1)
        pos_out.append(np.asarray(pos[:b][:k], np.int64) + base)
        x_out.append(np.asarray(xs[:b][:k], np.float32))
        y_out.append(np.asarray(ys[:b][:k], np.float32))
    if not pos_out:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0, np.float32), np.zeros(0, np.float32)
    pos = np.concatenate(pos_out)
    i, j = fold_inverse(pos, n_pad)
    return (i.astype(np.int32), j.astype(np.int32),
            np.concatenate(x_out), np.concatenate(y_out))


def refine_fit_device_2d(cd, scale, mean0, mean1, max_move=0.9,
                         min_move=1e-9, score_idx=0, betweenness_sample=100,
                         seed=42, grid=20, max_sweep_fetch=40_000_000,
                         no_local=False):
    """Unconstrained 2-D boundary optimisation over a streaming
    population (models/refine.refine_fit unconstrained branch,
    PopPUNK/refine.py:116-166, with the host matrix replaced by one
    streaming counts pass + one O(E) fetch).

    Cells whose in-boundary pair count exceeds max_sweep_fetch score 1
    (worst) — the optimum never captures a between-strain-scale pair
    fraction. Returns (optimal_x, optimal_y, sweep_data) with
    sweep_data = ("sparse2d", i, j, xs, ys).
    """
    from .network.incremental import grow_network_scores
    from .utils import decision_boundary

    rng = np.random.default_rng(seed)
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
    x_start, y_start = decision_boundary(np.copy(mean0), gradient,
                                         adj=-min_move)
    x_end, y_end = decision_boundary(np.copy(mean1), gradient,
                                     adj=max_move)
    if x_start < -1e-9 or y_start < -1e-9:
        raise RuntimeError("Boundary range below zero")
    x_max = np.linspace(x_start, x_end, grid, dtype=np.float32)
    y_max = np.linspace(y_start, y_end, grid, dtype=np.float32)

    cum = sweep2d_counts_streaming(cd, scale, x_max, y_max)
    if cum[-1, -1] == cd.n_pairs:
        raise SweepSaturated("Boundary range includes all points")
    scoreable = cum <= max_sweep_fetch
    if not scoreable.any():
        raise SweepSaturated(
            f"tightest 2-D cell already holds {cum[0, 0]} pairs "
            f"(> max_sweep_fetch {max_sweep_fetch})")
    if not scoreable.all():
        sys.stderr.write(
            f"refine 2D: {int((~scoreable).sum())}/{grid * grid} cells "
            f"hold > max_sweep_fetch ({max_sweep_fetch}) pairs; "
            "scored as 1\n")
    # per-row widest scoreable x_max (rows are nested in x, so the
    # scoreable region of a row is a prefix)
    n_act = scoreable.sum(axis=1)
    x_caps = np.where(n_act > 0, x_max[np.maximum(n_act - 1, 0)],
                      0.0).astype(np.float32)
    i, j, xs, ys = sweep2d_fetch_streaming(cd, scale, x_caps, y_max)

    global_s = np.ones((grid, grid))
    xs64 = xs.astype(np.float64)
    ys64 = ys.astype(np.float64)
    for r in range(grid):
        if n_act[r] == 0:
            continue
        # first x offset of each fetched pair in this row: inside at
        # x_max[k] iff x * ym / (ym - y) <= x_max[k] (rounding at
        # boundary-grazing pairs can shift one cell, same caveat as
        # threshold_iterate_1d_fast); pairs never inside get
        # idx >= n_act[r] and are dropped
        ym = float(y_max[r])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(ys64 < ym, xs64 * ym / (ym - ys64), np.inf)
        idx = np.searchsorted(x_max[:int(n_act[r])].astype(np.float64), t,
                              side="left").astype(np.int32)
        keep = idx < int(n_act[r])
        global_s[r, :n_act[r]] = grow_network_scores(
            cd.n, i[keep], j[keep], idx[keep], int(n_act[r]),
            score_idx, betweenness_sample, rng=rng)
    global_s[np.isnan(global_s)] = 1
    r_min, c_min = np.unravel_index(int(np.argmin(global_s)),
                                    global_s.shape)
    optimal_x = float(x_max[c_min])
    optimal_y = float(y_max[r_min])

    interior = (x_start < optimal_x < x_end and y_start < optimal_y < y_end
                and scoreable[min(r_min + 1, grid - 1),
                              min(c_min + 1, grid - 1)])
    if interior and not no_local:
        # local 1-D refinement along the optimum's gradient line
        # (refine.py:159-164): micro-grid via the native engine, two
        # bisection levels like the 1-D streaming path. The upper bound
        # is clamped so every probed boundary stays inside the fetched
        # union (x <= x_max[c_min+1] AND the induced y <= y_max[r_min+1])
        delta = float(x_max[1] - x_max[0])
        x0, y0 = optimal_x, optimal_y
        grad_l = x0 / y0
        best = global_s[r_min, c_min]
        # bisect in ABSOLUTE s around the fixed grid optimum (the 1-D
        # twin's convention) so level 2 refines level 1's winning
        # interval rather than re-shifting an already-moved optimum
        hi_y = x0 * (float(y_max[r_min + 1]) / y0 - 1.0)
        lo, hi = -delta, min(delta, hi_y)
        for _level in range(2):
            sub_s = np.linspace(lo, hi, 18)[1:-1]
            cells = [(x0 + s, (x0 + s) / grad_l) for s in sub_s]
            scores = np.ones(len(cells))
            for ci, (xm, ym) in enumerate(cells):
                if xm <= 0 or ym <= 0:
                    continue
                mask = inside_2d_host(xs, ys, xm, ym)
                scores[ci] = grow_network_scores(
                    cd.n, i[mask], j[mask],
                    np.zeros(int(mask.sum()), np.int32), 1, score_idx,
                    betweenness_sample, rng=rng)[0]
            k_min = int(np.argmin(scores))
            if scores[k_min] < best:
                best = scores[k_min]
                optimal_x, optimal_y = cells[k_min]
            lo = sub_s[k_min - 1] if k_min > 0 else lo
            hi = sub_s[k_min + 1] if k_min < len(sub_s) - 1 else hi
    if optimal_x < 0 or optimal_y < 0:
        raise RuntimeError("Optimisation produced a boundary outside range")
    return float(optimal_x), float(optimal_y), ("sparse2d", i, j, xs, ys)


# ---------------------------------------------------------------------------
# Boundary sweep over the device buffer


def _line_d0_params(offsets, slope, x0, y0, x1, y1):
    """Thresholds t[o] such that a pair is inside offset o's boundary iff
    d0 <= t[o], with d0 the signed distance at the first offset — exactly
    ops/boundary.threshold_iterate_1d_fast's construction. Also returns
    the reference boundary (xm0, ym0) that defines d0."""
    from .ops.boundary import _boundary_params, line_dist

    x_max, y_max = _boundary_params(offsets, slope, x0, y0, x1, y1)
    if slope == 1:
        bpts = np.stack([np.zeros_like(y_max), y_max], axis=1)
    else:
        bpts = np.stack([x_max, np.zeros_like(x_max)], axis=1)
    t = line_dist(bpts.astype(np.float32), float(x_max[0]),
                  float(y_max[0]), slope)
    return float(x_max[0]), float(y_max[0]), np.maximum.accumulate(t)


def _inside_2d(x, y, xm, ym):
    """Pair (x, y) inside the slope-2 boundary through (xm, 0), (0, ym)
    — ops/boundary.line_dist <= 0, incl. the degenerate-axis sqrt case.
    THE single definition of the 2-D membership rule; every streaming
    pass (sharded or not) must call this (or its host twin
    inside_2d_host) so the semantics cannot drift."""
    linear = y * xm + x * ym - xm * ym
    d = jnp.where(xm * ym == 0, jnp.sqrt(x * x + y * y), linear)
    return d <= 0


def inside_2d_host(x, y, xm, ym):
    """Host twin of _inside_2d for already-fetched pair coordinates —
    same rule, numpy, f32 arithmetic like the device passes. Change the
    two together."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if xm * ym == 0:
        return np.sqrt(x * x + y * y) <= 0
    return y * np.float32(xm) + x * np.float32(ym) \
        - np.float32(xm) * np.float32(ym) <= 0


@partial(jax.jit, static_argnames=("slope",))
def _d0_chunk(chunk_x, scale, xm0, ym0, slope):
    """Signed distance of each pair to the d0 reference boundary."""
    Xs = chunk_x / scale
    x, y = Xs[..., 0], Xs[..., 1]
    if slope == 2:
        linear = y * xm0 + x * ym0 - xm0 * ym0
        return jnp.where(xm0 * ym0 == 0, jnp.sqrt(x * x + y * y), linear)
    return x - xm0 if slope == 0 else y - ym0


@partial(jax.jit, static_argnames=("slope", "n_act"))
def _sweep_gather(chunk_x, scale, t, xm0, ym0, slope, n_act=None):
    """For one buffer chunk: sorted in-chunk positions of pairs inside
    the n_act'th boundary (padded with m), their first offsets, d0,
    count, and the full first-offset histogram."""
    d0 = _d0_chunk(chunk_x, scale, xm0, ym0, slope)
    idx = jnp.searchsorted(t, d0, side="left")
    active = idx < (t.shape[0] if n_act is None else n_act)
    m = chunk_x.shape[0]
    pos = jnp.sort(jnp.where(active, jnp.arange(m), m))
    safe = jnp.clip(pos, 0, m - 1)
    hist = jnp.bincount(idx, length=t.shape[0] + 1)
    return pos, jnp.take(idx, safe), jnp.take(d0, safe), active.sum(), hist


def _bucket_pow2(k, lo=1024):
    b = lo
    while b < k:
        b *= 2
    return b


@partial(jax.jit, static_argnames=("slope",))
def _sweep_counts_chunk(chunk_x, scale, t, xm0, ym0, slope):
    """First-offset histogram of one buffer chunk (counts only; the last
    bin holds pairs outside the widest boundary)."""
    d0 = _d0_chunk(chunk_x, scale, xm0, ym0, slope)
    idx = jnp.searchsorted(t, d0, side="left")
    return jnp.bincount(idx, length=t.shape[0] + 1)


@partial(jax.jit, static_argnames=("slope", "chunk_rows", "steps"))
def _buf_sweep_counts(buf, start, scale, t, xm0, ym0, slope, chunk_rows,
                      steps):
    """Histogram over `steps` buffer chunks in ONE dispatch (lax.scan —
    one dispatch instead of a chunked host loop).
    int32 accumulation is safe: a dispatch covers <= PAIRS_PER_DISPATCH
    < 2^31 pairs."""

    def step(acc, s):
        rows = jax.lax.dynamic_slice_in_dim(
            buf, start + s * chunk_rows, chunk_rows, 0)
        counts = _sweep_counts_chunk(rows.reshape(-1, 2), scale, t,
                                     xm0, ym0, slope)
        return acc + counts, None

    acc0 = jnp.zeros(t.shape[0] + 1, jnp.int32)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(steps))
    return acc


def sweep_counts_buffered(cd, scale, offsets, slope, x0, y0, x1, y1,
                          chunk_rows=1024):
    """Buffered twin of sweep_counts_streaming: cumulative in-boundary
    pair count per offset from the folded device buffer, no pair fetch.
    Full chunks ride scanned dispatches bounded by PAIRS_PER_DISPATCH;
    the ragged tail is one extra small dispatch."""
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    xm0_d, ym0_d = jnp.float32(xm0), jnp.float32(ym0)
    half = fold_rows(cd.n)
    chunk_rows = min(chunk_rows, half)
    steps_cap = max(1, int(PAIRS_PER_DISPATCH // ((cd.n - 1) * chunk_rows)))
    counts = np.zeros(len(t) + 1, np.int64)
    full = half // chunk_rows
    for s0 in range(0, full, steps_cap):
        steps = min(steps_cap, full - s0)
        counts += np.asarray(
            _buf_sweep_counts(cd.buf, jnp.int32(s0 * chunk_rows),
                              scale_dev, t_dev, xm0_d, ym0_d, int(slope),
                              chunk_rows, steps), np.int64)
    if full * chunk_rows < half:
        tail = cd.buf[full * chunk_rows:half].reshape(-1, 2)
        counts += np.asarray(
            _sweep_counts_chunk(tail, scale_dev, t_dev, xm0_d, ym0_d,
                                int(slope)), np.int64)
    return np.cumsum(counts[:-1])


def sweep_counts_streaming(cd, scale, offsets, slope, x0, y0, x1, y1):
    """Cumulative in-boundary pair count per offset (exact int64), no
    pair fetch — the cheap pre-pass that sizes the real sweep."""
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    cum = np.zeros(len(t), np.int64)
    if cd._mesh is not None:
        return sweep_counts_mesh(cd, scale, offsets, slope, x0, y0, x1,
                                 y1)[0]
    n_pad = cd._n_pad
    half = fold_rows(n_pad)
    nr = cd._n_real if cd._n_real < n_pad else None
    for off, fsteps in _dispatch_plan(half, cd.chunk, n_pad):
        cums = _stream_sweep_counts(
            cd.planes, cd.lengths, cd.freqs,
            jnp.int32(off * cd.chunk), scale_dev, t_dev,
            jnp.float32(xm0), jnp.float32(ym0), cd.chunk, int(fsteps),
            cd._klist, cd._ss64, cd._bbits, cd._pad_bits, int(slope),
            cd._use_pallas, nr)
        cum += np.asarray(cums, np.int64).sum(axis=0)
    return cum


def sweep_counts_mesh(cd, scale, offsets, slope, x0, y0, x1, y1):
    """Mesh-sharded exact counts: (global_cum i64[n_grid],
    per_dev i64[n_dev, n_grid]) cumulative in-boundary pair counts.
    per_dev row d counts exactly the pairs device d's fill shard will
    append (row- and column-sharded alike) — the sizing input for the
    sharded sweep_fill_device."""
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    per_dev = np.zeros((cd._n_dev, len(t)), np.int64)
    # row- and column-sharded counts share shape: [stacked devices,
    # n_offsets] per dispatch, host-summed; only the plan differs
    # (per-device rows vs all folded rows)
    for off, fsteps in _dispatch_plan(cd._plan_rows, cd.chunk,
                                      cd._plan_width):
        fn = cd._sh.counts(int(slope), int(fsteps))
        cums = fn(cd.planes, cd.lengths, cd.freqs, jnp.int32(off),
                  scale_dev, t_dev, jnp.float32(xm0),
                  jnp.float32(ym0))
        per_dev += np.asarray(cums, np.int64)
    return per_dev.sum(axis=0), per_dev


def _col_decode(pos, off, c, n_loc, n_pad, dev):
    """Decode a column-sharded fetch's flat tile positions to global
    (i, j) pairs, i < j. The tile layout is [fsteps, 2c, n_loc] row-major
    with rows = folded chunk rows (first c: s..s+c-1; second c:
    n-s-c..n-s-1) and columns = device dev's genome block."""
    s_idx, rem = np.divmod(pos, 2 * c * n_loc)
    a_row, lcol = np.divmod(rem, n_loc)
    s = (off + s_idx) * c
    i = np.where(a_row < c, s + a_row, n_pad - s - c + (a_row - c))
    j = dev * n_loc + lcol
    return i.astype(np.int32), j.astype(np.int32)


def sweep_first_offsets(cd, scale, offsets, slope, x0, y0, x1, y1,
                        chunk_rows=1024, _n_act=None):
    """Device twin of threshold_iterate_1d_fast over the folded buffer.

    Returns (i, j, first_offset, d0) host arrays for pairs inside the
    widest boundary — the native sparse scorer's input, plus each pair's
    signed distance d0 for re-thresholding at arbitrary offsets (the
    local-optimisation step) without touching the buffer again. Fetches
    O(E), never the buffer. On a StreamingCondensed each chunk is
    recomputed from the sketches instead of sliced from the buffer.
    """
    streaming = cd.buf is None
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    xm0_dev = jnp.float32(xm0)
    ym0_dev = jnp.float32(ym0)
    n_pad = getattr(cd, "_n_pad", cd.n)  # padded layout width
    half = fold_rows(n_pad)
    pos_out, idx_out, d0_out = [], [], []
    if streaming and getattr(cd, "_col", False):
        # column-sharded fetch: each device compacts its column slice of
        # every chunk tile; positions come back in local tile coordinates
        # and decode directly to (i, j) — no fold_inverse. Pair order is
        # (device, dispatch, tile) — a different (but valid) permutation
        # from the single-device folded order; all consumers are
        # order-independent (sparse scorer, re-thresholding, network).
        plan = _dispatch_plan(half, cd.chunk, cd._plan_width,
                              cap_rows=int(1.5e9 / (18 * cd._n_loc)))
        n_act = len(t) if _n_act is None else _n_act
        i_out, j_out = [], []
        for off, fsteps in plan:
            fn = cd._sh.fetch(int(slope), int(fsteps))
            m_loc = fsteps * 2 * cd.chunk * cd._n_loc
            pos, idxs, d0s, counts = fn(
                cd.planes, cd.lengths, cd.freqs, jnp.int32(off),
                jnp.int32(n_act), scale_dev, t_dev, xm0_dev, ym0_dev)
            counts_h = np.asarray(counts)
            for d in range(cd._n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                i, j = _col_decode(np.asarray(pos[d, :b][:k], np.int64),
                                   off, cd.chunk, cd._n_loc, n_pad, d)
                i_out.append(i)
                j_out.append(j)
                idx_out.append(np.asarray(idxs[d, :b][:k], np.int32))
                d0_out.append(np.asarray(d0s[d, :b][:k], np.float32))
        if not i_out:
            z = np.zeros(0, np.int32)
            return z, z, z, np.zeros(0, np.float32)
        return (np.concatenate(i_out), np.concatenate(j_out),
                np.concatenate(idx_out),
                np.concatenate(d0_out))
    if streaming and cd._mesh is not None:
        # sharded fetch: every device compacts its own row range; host
        # buckets are reassembled in (device, group) order = ascending
        # global row order, matching the single-device path exactly
        plan = _dispatch_plan(cd._half_loc, cd.chunk, n_pad,
                              cap_rows=int(1.5e9 / (9 * n_pad)))
        n_act = len(t) if _n_act is None else _n_act
        parts = {}
        for gi, (off, fsteps) in enumerate(plan):
            fn = cd._sh.fetch(int(slope), int(fsteps))
            m_loc = fsteps * cd.chunk * (n_pad - 1)
            pos, idxs, d0s, counts = fn(
                cd.planes, cd.lengths, cd.freqs, jnp.int32(off),
                jnp.int32(n_act), scale_dev, t_dev, xm0_dev, ym0_dev)
            counts_h = np.asarray(counts)
            for d in range(cd._n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                base = (d * cd._half_loc
                        + off * cd.chunk) * (n_pad - 1)
                parts[(d, gi)] = (
                    np.asarray(pos[d, :b][:k], np.int64) + base,
                    np.asarray(idxs[d, :b][:k], np.int32),
                    np.asarray(d0s[d, :b][:k], np.float32))
        for d in range(cd._n_dev):
            for gi in range(len(plan)):
                if (d, gi) in parts:
                    p, ix, dd = parts[(d, gi)]
                    pos_out.append(p)
                    idx_out.append(ix)
                    d0_out.append(dd)
        return _finalise_sweep(pos_out, idx_out, d0_out, n_pad)
    if streaming:
        # compaction buffers are ~9 bytes per pair in the dispatch's row
        # range; cap rows so they stay ~1.5 GB alongside the planes
        chunk_rows = _dispatch_plan(
            half, cd.chunk, n_pad,
            cap_rows=int(1.5e9 / (9 * n_pad)))[0][1] * cd.chunk
    for s in range(0, half, chunk_rows):
        rows = min(chunk_rows, half - s)
        if streaming:
            m = rows * (n_pad - 1)
            n_act = len(t) if _n_act is None else _n_act
            nr = cd._n_real if cd._n_real < n_pad else None
            pos, idx, d0, count, _ = _stream_sweep_group(
                cd.planes, cd.lengths, cd.freqs, jnp.int32(s),
                jnp.int32(n_act), scale_dev, t_dev, xm0_dev, ym0_dev,
                cd.chunk, int(rows // cd.chunk), cd._klist, cd._ss64,
                cd._bbits, cd._pad_bits, int(slope), cd._use_pallas, nr)
        else:
            chunk_x = cd.buf[s:s + rows].reshape(-1, 2)
            m = chunk_x.shape[0]
            n_act = len(t) if _n_act is None else _n_act
            pos, idx, d0, count, _ = _sweep_gather(
                chunk_x, scale_dev, t_dev, xm0_dev, ym0_dev, int(slope),
                n_act=int(n_act))
        k = int(count)
        if k == 0:
            continue
        # fetch a power-of-two bucket (few distinct slice programs), trim
        b = min(_bucket_pow2(k), m)
        base = s * (n_pad - 1)
        pos_out.append(np.asarray(pos[:b][:k], np.int64) + base)
        idx_out.append(np.asarray(idx[:b][:k], np.int32))
        d0_out.append(np.asarray(d0[:b][:k], np.float32))
    return _finalise_sweep(pos_out, idx_out, d0_out, n_pad)


def _finalise_sweep(pos_out, idx_out, d0_out, n):
    """Folded flat positions -> (i, j, first_offset, d0) host arrays.

    int32 outputs: n < 2^31 always, the native scorer consumes int32,
    and at E ~ 1e7+ the fetch/RSS halves. Decode PER PART, consuming
    each int64 position buffer as it goes: a whole-fetch decode holds
    pos + i + j in int64 at once — ~2 GB of transient peak-RSS at the
    40M-pair fetch cap, vs one dispatch's worth here."""
    if not pos_out:
        z = np.zeros(0, np.int32)
        return z, z, z, np.zeros(0, np.float32)
    i_parts, j_parts = [], []
    while pos_out:
        pos = pos_out.pop(0)
        i, j = fold_inverse(pos, n)
        i_parts.append(i.astype(np.int32))
        j_parts.append(j.astype(np.int32))
    return (np.concatenate(i_parts), np.concatenate(j_parts),
            np.concatenate(idx_out).astype(np.int32),
            np.concatenate(d0_out))


def offset_threshold(s_value, offsets, slope, x0, y0, x1, y1):
    """t(s) comparable against the d0 returned by sweep_first_offsets:
    a pair is inside the boundary at line offset s iff d0 <= t(s)."""
    _, _, t = _line_d0_params(
        np.array([offsets[0], s_value]), slope, x0, y0, x1, y1)
    return t[1]


# ---------------------------------------------------------------------------
# Device-resident sweep edges: the fill pass for ops/sparse_sweep
#
# Same enumeration as sweep_first_offsets, but the compacted in-boundary
# pairs are appended into device buffers instead of crossing to the host.
# The host sees one count scalar per dispatch; scoring then runs on device
# (ops/sparse_sweep.sweep_scores_sparse_device) and only the optimal
# boundary's edges are ever fetched.


@partial(jax.jit, static_argnames=("n", "b"), donate_argnums=(0, 1, 2))
def _fill_append(bi, bj, bd, pos_b, d0_b, k, acc, row0, n, b):
    """Append one dispatch's compacted pairs to the edge buffers.

    pos_b: i32[b] sorted local flat positions (pads hold the window
    size m >= anything real — masked out by lane < k); decoded to global
    (i, j) with the fold_inverse arithmetic, all int32-exact because the
    row index is split out (row0) before the divmod."""
    lane = jnp.arange(b, dtype=jnp.int32)
    mask = lane < k
    r = pos_b // (n - 1) + row0
    q = pos_b % (n - 1)
    first = q < n - 1 - r
    i = jnp.where(first, r, n - 1 - r)
    j = jnp.where(first, q + r + 1, q + 1)
    cap = bi.shape[0]
    dest = jnp.where(mask, acc + lane, cap)  # out-of-range -> dropped
    bi = bi.at[dest].set(jnp.where(mask, i, n), mode="drop")
    bj = bj.at[dest].set(jnp.where(mask, j, n), mode="drop")
    bd = bd.at[dest].set(jnp.where(mask, d0_b, jnp.inf), mode="drop")
    return bi, bj, bd


def _sweep_fill_mesh(cd, scale, offsets, slope, x0, y0, x1, y1, n_act,
                     e_total, e_per_dev=None):
    """Mesh arm of sweep_fill_device (row- AND column-sharded): each
    device appends its own pairs — decoded to global (i, j) on device —
    into its shard of the edge buffers, then the shards are all-gathered
    ON DEVICE (an XLA collective, never through the host) into
    the replicated edge list that sweep_scores_sparse_device scores.
    The host sees one (histogram, count) pair per dispatch.

    e_per_dev: exact per-device pair counts (from sweep_counts_mesh)
    when available — sizes each shard tight. Otherwise each shard takes
    the global estimate's per-device share with a 2x skew guard (strain
    blocks are contiguous in row/column space, so one shard can hold
    well over the mean); a shard overflow raises SweepFillOverflow and
    the caller falls back to exact counts."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .ops.sparse_sweep import SweepEdges, _bucket as _ss_bucket

    mesh = cd._mesh
    n_dev = cd._n_dev
    n_pad = cd._n_pad
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    xm0_dev, ym0_dev = jnp.float32(xm0), jnp.float32(ym0)

    if e_per_dev is not None:
        need = int(np.max(e_per_dev))
        e_loc = _ss_bucket(need + max(1024, need // 128))
    else:
        est = max(int(e_total), 1)
        share = min(est, 2 * est // n_dev + 1)
        e_loc = _ss_bucket(share + max(1024, est // 128))

    sh2 = NamedSharding(mesh, P(("q", "r"), None))
    sh1 = NamedSharding(mesh, P(("q", "r")))

    @partial(jax.jit, out_shardings=(sh2, sh2, sh2, sh1))
    def init_buffers():
        return (jnp.full((n_dev, e_loc), n_pad, jnp.int32),
                jnp.full((n_dev, e_loc), n_pad, jnp.int32),
                jnp.full((n_dev, e_loc), jnp.inf, jnp.float32),
                jnp.zeros(n_dev, jnp.int32))

    bi, bj, bd, acc = init_buffers()
    counts = np.zeros(len(t) + 1, np.int64)
    acc_host = np.zeros(n_dev, np.int64)

    if cd._col:
        plan = _dispatch_plan(cd._plan_rows, cd.chunk, cd._plan_width,
                              cap_rows=int(1.0e9 / (18 * cd._n_loc)))
    else:
        plan = _dispatch_plan(cd._half_loc, cd.chunk, n_pad,
                              cap_rows=int(1.0e9 / (18 * n_pad)))

    # double-buffered: the host fetch of dispatch i's scalars happens
    # after dispatch i+1 is queued, so the devices never idle on the
    # host round-trip
    pending = None
    for off, fsteps in plan:
        fn = cd._sh.fill(int(slope), int(fsteps))
        bi, bj, bd, acc, hist, cnt = fn(
            cd.planes, cd.lengths, cd.freqs, bi, bj, bd, acc,
            jnp.int32(off), jnp.int32(n_act), scale_dev, t_dev,
            xm0_dev, ym0_dev)
        if pending is not None:
            h, k = pending
            counts += np.asarray(h, np.int64).sum(axis=0)
            acc_host += np.asarray(k, np.int64)
        pending = (hist, cnt)
    if pending is not None:
        h, k = pending
        counts += np.asarray(h, np.int64).sum(axis=0)
        acc_host += np.asarray(k, np.int64)
    if np.any(acc_host > e_loc):
        d_bad = int(np.argmax(acc_host))
        raise SweepFillOverflow(
            f"sweep fill overflow: device {d_bad} holds "
            f"{int(acc_host[d_bad])} pairs > shard buffer {e_loc} "
            f"(estimated {e_total} total)")

    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda a: a.reshape(-1), out_shardings=rep)
    edges = SweepEdges(gather(bi), gather(bj), gather(bd),
                       int(acc_host.sum()), n_pad, n_real=cd._n_real)
    return edges, np.cumsum(counts[:-1])


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "slope",
                                   "use_pallas", "n_real"),
         donate_argnums=(0, 1, 2, 3))
def _stream_fill_group(bi, bj, bd, acc, planes, lengths, freqs, s0, n_act,
                       scale, t, xm0, ym0, c, steps, klist, sketchsize64,
                       bbits, pad_bits, slope, use_pallas, n_real=None):
    """Fill-pass dispatch with DIRECT append: recompute `steps` folded
    chunks from row s0 and scatter every in-boundary pair straight into
    the device edge buffers at prefix-sum destinations — no compaction
    sort, no pos round-trip, no separate _fill_append dispatch (the
    sort-based fill's three-stage pipeline costs ~2x the enumeration
    floor). The offset histogram is computed as direct cumulative
    threshold compares (one fused compare+reduce per offset) instead of
    searchsorted + bincount — no gather chains, no scatter-add.

    Buffers are donated and carried across dispatches; `acc` is the
    device-resident running edge count (the host fetches it once per
    dispatch for the overflow check). Overflowing destinations drop
    (mode="drop"), so a too-small buffer truncates and the caller's
    post-hoc acc check raises SweepFillOverflow before anything is
    scored. Returns (bi, bj, bd, acc, cum) where cum is this dispatch's
    CUMULATIVE in-boundary pair count per offset (i32[n_t]; a dispatch
    covers <= PAIRS_PER_DISPATCH < 2^31 pairs, the host accumulates
    int64)."""
    n = planes.shape[2]
    cap = bi.shape[0]
    t_band = t[n_act - 1]  # widest active offset's threshold

    def step(carry, s):
        bi, bj, bd, acc, cum = carry
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        d0 = _d0_chunk(folded.reshape(-1, 2), scale, xm0, ym0, slope)
        cum = cum + jax.vmap(
            lambda tv: (d0 <= tv).sum(dtype=jnp.int32))(t)
        active = d0 <= t_band
        dest = acc + jnp.cumsum(active.astype(jnp.int32)) - 1
        m = d0.shape[0]
        pos = jnp.arange(m, dtype=jnp.int32)
        # dropped lanes get cap + lane: all destinations unique (see
        # _stream_stats_fill_range)
        dest = jnp.where(active, dest, cap + pos)
        r = pos // (n - 1) + s
        q = pos % (n - 1)
        first = q < n - 1 - r
        gi = jnp.where(first, r, n - 1 - r)
        gj = jnp.where(first, q + r + 1, q + 1)
        bi = bi.at[dest].set(gi, mode="drop", unique_indices=True)
        bj = bj.at[dest].set(gj, mode="drop", unique_indices=True)
        bd = bd.at[dest].set(d0, mode="drop", unique_indices=True)
        acc = acc + active.sum(dtype=jnp.int32)
        return (bi, bj, bd, acc, cum), None

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    cum0 = jnp.zeros(t.shape[0], jnp.int32)
    (bi, bj, bd, acc, cum), _ = jax.lax.scan(
        step, (bi, bj, bd, acc, cum0), starts)
    return bi, bj, bd, acc, cum


def sweep_fill_device(cd, scale, offsets, slope, x0, y0, x1, y1, n_act,
    e_total, chunk_rows=1024, e_per_dev=None):
    """Stream every pair whose first offset is < n_act into
    device-resident buffers; returns (SweepEdges, cum) where cum is the
    EXACT cumulative in-boundary pair count per offset — the fill's own
    histogram, so no separate counts pre-pass is needed.

    e_total: expected pair count (exact from a counts pass, or a
    subsample estimate with margin) — sizes the buffers. Covers the
    buffered, single-device streaming, AND mesh-sharded (row/column)
    tiers; the mesh arm appends per-device shards and all-gathers them
    on device (_sweep_fill_mesh)."""
    from .ops.sparse_sweep import SweepEdges, _bucket as _ss_bucket

    streaming = cd.buf is None
    if streaming and getattr(cd, "_mesh", None) is not None:
        return _sweep_fill_mesh(cd, scale, offsets, slope, x0, y0, x1,
                                y1, n_act, e_total, e_per_dev)
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    t_dev = jnp.asarray(t, jnp.float32)
    scale_dev = jnp.asarray(scale, jnp.float32)
    xm0_dev, ym0_dev = jnp.float32(xm0), jnp.float32(ym0)
    n_pad = getattr(cd, "_n_pad", cd.n)
    half = fold_rows(n_pad)

    # e_total comes from the counts pass — a DIFFERENT compiled program
    # whose d0 can differ by float-reassociation ulps from this one's,
    # so pairs sitting exactly on a threshold may tip either way. Size
    # with slack and only fail on true buffer overflow.
    e_est = max(int(e_total), 1)
    e_alloc = _ss_bucket(e_est + max(1024, e_est // 128))
    bi = jnp.full(e_alloc, n_pad, jnp.int32)
    bj = jnp.full(e_alloc, n_pad, jnp.int32)
    bd = jnp.full(e_alloc, jnp.inf, jnp.float32)
    acc = 0
    counts = np.zeros(len(t) + 1, np.int64)

    if streaming:
        # direct-append fill (_stream_fill_group): per-chunk transients
        # only (~20 B per chunk pair), so the dispatch size is bounded
        # by PAIRS_PER_DISPATCH, not memory
        nr = cd._n_real if cd._n_real < n_pad else None
        chunk_rows = _dispatch_plan(half, cd.chunk, n_pad)[0][1] * cd.chunk
        acc_dev = jnp.int32(0)
        cum64 = np.zeros(len(t), np.int64)
        # the edge/acc carries are donated device-resident; only the
        # per-dispatch cum fetch blocks the host, one dispatch behind
        # (the devices never idle on the host round-trip)
        pending = None
        for s in range(0, half, chunk_rows):
            rows = min(chunk_rows, half - s)
            bi, bj, bd, acc_dev, cum = _stream_fill_group(
                bi, bj, bd, acc_dev, cd.planes, cd.lengths, cd.freqs,
                jnp.int32(s), jnp.int32(n_act), scale_dev, t_dev,
                xm0_dev, ym0_dev, cd.chunk, int(rows // cd.chunk),
                cd._klist, cd._ss64, cd._bbits, cd._pad_bits, int(slope),
                cd._use_pallas, nr)
            if pending is not None:
                cum64 += np.asarray(pending, np.int64)
            pending = cum
        if pending is not None:
            cum64 += np.asarray(pending, np.int64)
        acc = int(acc_dev)
        if acc > e_alloc:
            raise SweepFillOverflow(
                f"sweep fill overflow: {acc} pairs > buffer "
                f"{e_alloc} (counts pass estimated {e_total})")
        n_real = getattr(cd, "_n_real", cd.n)
        return (SweepEdges(bi, bj, bd, acc, n_pad, n_real=n_real), cum64)

    def enumerate_chunk(s, rows):
        chunk_x = cd.buf[s:s + rows].reshape(-1, 2)
        m = chunk_x.shape[0]
        pos, _, d0, count, hist = _sweep_gather(
            chunk_x, scale_dev, t_dev, xm0_dev, ym0_dev, int(slope),
            n_act=int(n_act))
        return pos, d0, count, hist, m, s

    def append(pending):
        nonlocal bi, bj, bd, acc, counts
        pos, d0, count, hist, m, s = pending
        counts += np.asarray(hist, np.int64)
        k = int(count)
        if k == 0:
            return
        if acc + k > e_alloc:
            raise SweepFillOverflow(
                f"sweep fill overflow: {acc + k} pairs > buffer "
                f"{e_alloc} (counts pass estimated {e_total})")
        b = min(_bucket_pow2(k), m)
        bi, bj, bd = _fill_append(
            bi, bj, bd, pos[:b], d0[:b], jnp.int32(k), jnp.int32(acc),
            jnp.int32(s), n_pad, int(b))
        acc += k

    # double-buffered: dispatch i+1 queues on device BEFORE dispatch i's
    # count/hist scalars are fetched, so the device never idles on the
    # host round-trip (the fetch blocks the host, not the device)
    pending = None
    for s in range(0, half, chunk_rows):
        rows = min(chunk_rows, half - s)
        nxt = enumerate_chunk(s, rows)
        if pending is not None:
            append(pending)
        pending = nxt
    if pending is not None:
        append(pending)
    n_real = getattr(cd, "_n_real", cd.n)
    return (SweepEdges(bi, bj, bd, acc, n_pad, n_real=n_real),
            np.cumsum(counts[:-1]))


@partial(jax.jit, static_argnames=("n",))
def _edge_label_prop(iv, jv, active, n, max_iters):
    """Min-label propagation over an edge list: labels converge to the
    per-component minimum vertex id. One while_loop runs to convergence
    on device (pointer-jumping keeps rounds ~O(log diameter))."""
    labels0 = jnp.arange(n + 1, dtype=jnp.int32)  # slot n = pad sink

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        labels, _, it = state
        li = labels[jnp.clip(iv, 0, n)]
        lj = labels[jnp.clip(jv, 0, n)]
        m = jnp.where(active, jnp.minimum(li, lj), n)
        labels = labels.at[iv].min(jnp.where(active, m, n), mode="drop")
        labels = labels.at[jv].min(jnp.where(active, m, n), mode="drop")
        # pointer-jump: label of my label (halves tree height per round)
        labels = labels[labels]
        changed = ((labels[jnp.clip(iv, 0, n)] != li)
                   | (labels[jnp.clip(jv, 0, n)] != lj)).any()
        return labels, changed, it + 1

    labels, changed, it = jax.lax.while_loop(
        cond, body, (labels0, jnp.bool_(True), jnp.int32(0)))
    return labels[:n], changed & (it >= max_iters)


def edge_components_device(edges, threshold):
    """Connected-component labels at a boundary from a SweepEdges list,
    computed on device — only O(n) labels cross the host link. Labels
    are compacted to 0..k-1 in first-seen order (the scipy/native
    convention used by components_native)."""
    k = int(edges.counts_at(np.array([threshold]))[0])
    active = jnp.arange(edges.i.shape[0], dtype=jnp.int32) < k
    max_iters = 4 * int(np.ceil(np.log2(max(edges.n, 2))) + 2)
    labels, hit_cap = _edge_label_prop(edges.i, edges.j, active,
                                       edges.n, jnp.int32(max_iters))
    if bool(hit_cap):
        raise RuntimeError("label propagation failed to converge")
    labels = np.asarray(labels)[:edges.n_real]
    _, compact = np.unique(labels, return_inverse=True)
    # np.unique orders by label value = min vertex id; first-seen order
    # of component roots is ascending root id as well, so this matches
    # the native union-find convention
    return compact, k


# ---------------------------------------------------------------------------
# Matmul sweep: score every offset on device, fetch O(1)
#
# For score_idx 0 the refine score is transitivity * (1 - density) —
# triangles and degrees, nothing else. Both are matrix products: with the
# signed distance d0 held as a dense [n, n] square in HBM, each offset's
# adjacency is a compare, 6*triangles = sum(A * (A@A)), wedges from row
# sums (each entry of A@A and each row sum is at most n < 2^24, so exact
# in f32). Unlike
# sweep_first_offsets -> native scorer, NOTHING of size O(E) ever crosses
# the host link — the sweep's widest boundary at production scale holds
# ~n^2/2 pairs (gigabytes to fetch), which is the reference's memory cliff too (its thresholdIterate materialises
# every in-boundary pair as host tuples, PopPUNK/refine.py:197-202).


# Dense [n, n] f32 d0 square + two scratch buffers; above
# memory_plan().matmul_sweep_max_n the sparse path runs instead.


@partial(jax.jit, static_argnames=("n", "c"))
def _unfold_block(d0_flat, s, n, c):
    """Rows [s, s+c) of the dense d0 square, gathered from the folded
    flat buffer (diagonal = +inf so self-pairs never join a network)."""
    i = (s + jnp.arange(c))[:, None]
    j = jnp.arange(n)[None, :]
    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    first = lo < n - 1 - lo
    r = jnp.where(first, lo, n - 1 - lo)
    q = jnp.where(first, hi - lo - 1, hi - 1)
    vals = jnp.take(d0_flat, r * (n - 1) + q)
    return jnp.where(i == j, jnp.inf, vals)


def build_d0_square(cd, scale, slope, x0, y0, x1, y1, offsets,
                    block_rows=2048):
    """Dense symmetric [n, n] f32 of per-pair signed boundary distances,
    entirely on device. Returns (d0_sq, thresholds t for the offsets)."""
    xm0, ym0, t = _line_d0_params(offsets, slope, x0, y0, x1, y1)
    d0_fold = _d0_chunk(cd.buf, jnp.asarray(scale, jnp.float32),
                        jnp.float32(xm0), jnp.float32(ym0), int(slope))
    d0_flat = d0_fold.reshape(-1)
    n = cd.n
    sq = jnp.zeros((n, n), jnp.float32)
    for s in range(0, n, block_rows):
        c = min(block_rows, n - s)
        sq = jax.lax.dynamic_update_slice(
            sq, _unfold_block(d0_flat, jnp.int32(s), n, int(c)), (s, 0))
    return sq, t


@partial(jax.jit, static_argnames=("n",))
def _matmul_sweep_scores(d0_sq, ts, n):
    """-(transitivity * (1 - density)) and edge count per threshold."""
    possible = 0.5 * n * (n - 1)

    def score(_, t):
        A = (d0_sq <= t).astype(jnp.float32)
        deg = A.sum(axis=1)
        # per-row sums are exact in f32 (< 2^24) but the total is not;
        # count edges in int32 so the saturation guard is reliable
        n_edges = (d0_sq <= t).sum(dtype=jnp.int32) // 2
        density = n_edges.astype(jnp.float32) / possible
        # per-element wedge/triangle counts are exact (< 2^24); the
        # aggregate sums can exceed 2^24 at dense offsets, where XLA's
        # tree reductions leave ~1e-6 relative error — negligible at
        # grid granularity (ops/device_sweep.py docstring)
        wedges2 = (deg * (deg - 1.0)).sum()
        # bf16 operands stay exact: entries are 0/1, accumulation is
        # f32 and row counts are < 2^24
        Ab = A.astype(jnp.bfloat16)
        paths = (A * jnp.dot(Ab, Ab,
                             preferred_element_type=jnp.float32)).sum()
        trans = jnp.where(wedges2 > 0, paths / wedges2, 0.0)
        return None, (-(trans * (1.0 - density)), n_edges)

    _, out = jax.lax.scan(score, None, ts)
    return out


def matmul_sweep_scores(d0_sq, thresholds):
    """Host wrapper: scores + edge counts for a threshold grid."""
    s, e = _matmul_sweep_scores(d0_sq, jnp.asarray(thresholds, jnp.float32),
                                int(d0_sq.shape[0]))
    return np.asarray(s, np.float64), np.asarray(e, np.int64)


@partial(jax.jit, static_argnames=("n",))
def _components_device(d0_sq, t, n):
    """Connected-component labels of the thresholded graph by min-label
    propagation (converged while_loop); also the edge count."""
    A = d0_sq <= t
    # int32 is safe: n_pairs at the 32768 cap is 5.4e8 < 2^31
    n_edges = A.sum(dtype=jnp.int32) // 2

    def cond(state):
        return state[1]

    def body(state):
        labels, _ = state
        cand = jnp.where(A, labels[None, :], n).min(axis=1)
        new = jnp.minimum(labels, cand)
        return new, (new != labels).any()

    labels0 = jnp.arange(n, dtype=jnp.int32)
    labels, _ = jax.lax.while_loop(cond, body, (labels0, jnp.bool_(True)))
    return labels, n_edges


def components_device(d0_sq, threshold):
    """Cluster labels (compacted to 0..k-1) + edge count at a boundary."""
    labels, n_edges = _components_device(
        d0_sq, jnp.float32(threshold), int(d0_sq.shape[0]))
    labels = np.asarray(labels)
    _, compact = np.unique(labels, return_inverse=True)
    return compact, int(n_edges)


# ---------------------------------------------------------------------------
# End-to-end scale pipeline (synthetic device population)


def _estimate_sweep_cum(est_pairs, scale, slope, xm0, ym0, t_all, n_pairs):
    """Subsample-estimated cumulative in-boundary pair count per offset,
    plus a conservative margin (6-sigma binomial + 2% + 1e5 slack).
    A uniform model-subsample estimate suffices to pick the scoreable
    range — the fill's idx < n_act filter is exact regardless, so scores
    never depend on the estimate. Returns (est_cum, est_margin)."""
    Xs = np.asarray(est_pairs, np.float64) / np.asarray(scale)
    xe, ye = Xs[:, 0], Xs[:, 1]
    if slope == 2:
        if xm0 * ym0 == 0:
            d0e = np.sqrt(xe * xe + ye * ye)
        else:
            d0e = ye * xm0 + xe * ym0 - xm0 * ym0
    elif slope == 0:
        d0e = xe - xm0
    else:
        d0e = ye - ym0
    m_e = len(d0e)
    frac = np.searchsorted(np.sort(d0e), t_all, side="right") / m_e
    est_cum = frac * n_pairs
    est_margin = (6.0 * n_pairs * np.sqrt(np.maximum(frac, 1e-12) / m_e)
                  + 0.02 * est_cum + 1e5)
    return est_cum, est_margin


def plan_sweep_band(cd, scale, mean0, mean1, max_move=0.9, min_move=1e-9,
                    n_grid=40, max_sweep_fetch=40_000_000, slope=2,
                    est_pairs=None):
    """Plan the bootstrap fill band for refine_fit_device's device
    sparse sweep BEFORE any streaming pass has run.

    The refine geometry is fully determined by the subsample fit (scale
    = the fit's subsample maxima, line = the fit's component means), so
    the in-boundary edge fill can ride pass 1
    (StreamingCondensed.run_pass1(fill_spec)) — the two-round bootstrap
    that removes the refine fill's full distance recompute. Mirrors
    refine_fit_device's s_range construction and offset-cap logic on the
    subsample estimate + margin; the band is what the exact-cum pick
    would choose, modulo the margin (refine caps its offset range to the
    band; a wider exact pick only loses offsets that are never optimal).

    Returns a fill_spec dict for run_pass1, or None when the device
    sparse sweep would not run (matmul tier, env-disabled, no HBM
    headroom, insufficient subsample). Raises SweepSaturated when even
    the first offset exceeds the cap (the caller shrinks max_move and
    replans — host arithmetic only, no device work wasted)."""
    from .ops.sparse_sweep import hbm_feasible, max_edge_cap

    if cd.buf is not None and cd.n <= memory_plan().matmul_sweep_max_n:
        return None
    if os.environ.get("POPPUNK_TPU_SPARSE_SWEEP", "1") == "0":
        return None
    if est_pairs is None or len(est_pairs) < 10000:
        return None
    n_pad = getattr(cd, "_n_pad", cd.n)
    resident = 0
    for t_res in (getattr(cd, "planes", None), cd.buf):
        if t_res is not None:
            resident += t_res.nbytes
    cap_dev = max_edge_cap(n_pad, resident)
    if cap_dev <= 0:
        return None
    cap_budget = cap_dev - cap_dev // 50
    search_length = max_move + float(np.sqrt(((mean1 - mean0) ** 2).sum()))
    s_range = np.linspace(-min_move, search_length, num=n_grid)
    line = (mean0[0], mean0[1], mean1[0], mean1[1])
    xm0, ym0, t_all = _line_d0_params(s_range, slope, *line)
    est_cum, est_margin = _estimate_sweep_cum(
        est_pairs, scale, slope, xm0, ym0, t_all, cd.n_pairs)
    bound = est_cum + est_margin
    eff_cap = max(max_sweep_fetch, int(bound[min(9, n_grid - 1)]) + 1)
    eff_cap = min(eff_cap, cap_budget)
    ok = np.nonzero(bound <= eff_cap)[0]
    if len(ok) == 0:
        raise SweepSaturated(
            f"first sweep offset already holds ~{int(est_cum[0])} "
            f"pairs (> max_sweep_fetch {eff_cap})")
    o_band = int(ok.max())
    e_total = int(bound[o_band])
    if not hbm_feasible(n_pad, e_total, resident):
        return None
    return dict(scale=np.asarray(scale, np.float64), offsets=s_range,
                slope=int(slope), line=line, n_act=o_band + 1,
                e_total=e_total)


def refine_fit_device(cd, scale, mean0, mean1, max_move=0.9, min_move=1e-9,
                      score_idx=0, betweenness_sample=100, seed=42,
                      n_grid=40, max_sweep_fetch=40_000_000, slope=2,
                      no_local=False, timings_out=None, est_pairs=None,
                      prefill=None):
    """Global + local 1-D boundary refinement over the device buffer.

    Mirrors models/refine.refine_fit (constrained): 40-point global
    sweep then a bounded scalar local optimisation; slope 2 moves the
    diagonal boundary, slope 0/1 the core-only / accessory-only vertical
    and horizontal boundaries (the --indiv-refine refits,
    PopPUNK/models.py:923-948). score_idx 0 runs the matmul sweep —
    every offset scored on device, O(1) fetched (see build_d0_square);
    the betweenness scores (idx 1/2) fetch the sparse in-boundary pairs
    once and score them with the native engine.
    Returns (optimal_x, optimal_y, s_opt, sweep_data); sweep_data is
    ("device", d0_sq, s_range, params) or
    ("sparse", i, j, idx, d0, s_range, params); for slope 0/1 the
    optimal value rides optimal_x / optimal_y respectively.

    Every sparse-scored sweep (buffered or streaming) first runs a
    counts-only histogram pass, then fetches pairs only for offsets
    whose cumulative count is <= max_sweep_fetch; denser offsets score 1
    (worst). The widest grid
    offsets sit past the between-strain mean and hold O(n_pairs/2)
    pairs — fetching them is the reference's memory cliff
    (PopPUNK/refine.py:197-202, a measured 21 GB host RSS here at 65k),
    and a boundary capturing that fraction of all pairs is never the
    transitivity*(1-density) optimum. If the argmin lands at the cap
    edge the fetch is widened once so the local bracket stays exact.
    """
    import scipy.optimize

    from .utils import decision_boundary, transform_line

    rng = np.random.default_rng(seed)
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
    search_length = max_move + float(np.sqrt(((mean1 - mean0) ** 2).sum()))
    s_range = np.linspace(-min_move, search_length, num=n_grid)
    line = (mean0[0], mean0[1], mean1[0], mean1[1])

    edges = None  # device-resident SweepEdges when the sparse path runs
    use_matmul = (score_idx == 0 and cd.n <= memory_plan().matmul_sweep_max_n
                  and cd.buf is not None)
    if use_matmul:
        d0_sq, t_grid = build_d0_square(cd, scale, slope, *line, s_range)
        global_s, edge_counts = matmul_sweep_scores(d0_sq, t_grid)
        if edge_counts[-1] == cd.n_pairs:
            raise SweepSaturated("Boundary range includes all points")
    else:
        from .network.incremental import grow_network_scores
        from .ops.sparse_sweep import (hbm_feasible, max_edge_cap,
                                       sweep_scores_sparse_device)

        # Device sparse sweep (ops/sparse_sweep): score_idx 0 at any n,
        # no O(E) host fetch — single-device, row-sharded, and
        # column-sharded alike (the mesh arms fill per-device shards and
        # all-gather them over ICI, _sweep_fill_mesh). Betweenness
        # scores (idx 1/2) use the host native engine.
        n_pad = getattr(cd, "_n_pad", cd.n)
        resident = 0
        for t_res in (getattr(cd, "planes", None), cd.buf):
            if t_res is not None:
                resident += t_res.nbytes
        if getattr(cd, "_col", False):
            # column-sharded planes: .nbytes is the GLOBAL size but each
            # device holds only its 1/n_dev column slice
            resident -= (cd.planes.nbytes
                         - cd.planes.nbytes // cd._n_dev)
        cap_dev = max_edge_cap(n_pad, resident)
        dev_possible = (
            score_idx == 0
            and os.environ.get("POPPUNK_TPU_SPARSE_SWEEP", "1") != "0"
            and cap_dev > 0)
        cap_budget = cap_dev - cap_dev // 50 if cap_dev else 0
        xm0_l, ym0_l, t_all = _line_d0_params(s_range, slope, *line)

        # bootstrap prefill: pass 1 already filled the boundary-band
        # edge list (run_pass1(plan_sweep_band(...))) and returned the
        # EXACT cumulative counts for the full grid — both the counts
        # pass and the fill pass are already paid for. The spec must
        # match this call's geometry exactly (it was planned from the
        # same fit); a mismatch silently ignores the prefill.
        pre_edges = None
        pre_nact = 0
        if prefill is not None and dev_possible:
            p_edges, p_cum, p_spec = prefill
            if (int(p_spec["slope"]) == int(slope)
                    and len(p_spec["offsets"]) == len(s_range)
                    and np.allclose(p_spec["offsets"], s_range)
                    and np.allclose(p_spec["line"], line)
                    and np.allclose(p_spec["scale"], np.asarray(scale))):
                pre_edges = p_edges
                pre_nact = int(p_spec["n_act"])
                pre_cum = np.asarray(p_cum, np.int64)

        # cumulative in-boundary pair counts per offset: a uniform
        # model-subsample ESTIMATE suffices to pick the scoreable range
        # (the fill pass returns exact counts for free; its idx < n_act
        # filter is exact regardless, so scores never depend on the
        # estimate) — skipping the dedicated counts pass saves a full
        # distance recompute (~2 min at 65k)
        est_cum = est_margin = None
        if (pre_edges is None and dev_possible and est_pairs is not None
                and len(est_pairs) >= 10000):
            est_cum, est_margin = _estimate_sweep_cum(
                est_pairs, scale, slope, xm0_l, ym0_l, t_all, cd.n_pairs)

        # exact-counts pass, shared by the three callers below (initial
        # no-estimate path, host-engine pre-fetch, overflow fallback);
        # on a mesh it also captures the per-device counts that size the
        # sharded fill's shards
        per_dev_cum = None

        def run_exact_counts():
            nonlocal per_dev_cum
            t_cn = time.perf_counter()
            if cd.buf is not None:
                out = sweep_counts_buffered(cd, scale, s_range, slope,
                                            *line)
            elif getattr(cd, "_mesh", None) is not None:
                out, per_dev_cum = sweep_counts_mesh(
                    cd, scale, s_range, slope, *line)
            else:
                out = sweep_counts_streaming(cd, scale, s_range, slope,
                                             *line)
            dt = time.perf_counter() - t_cn
            sys.stderr.write(f"refine: counts pass {dt:.1f}s\n")
            if timings_out is not None:
                timings_out["counts"] = (timings_out.get("counts", 0.0)
                                         + dt)
            if out[-1] == cd.n_pairs:
                raise SweepSaturated("Boundary range includes all points")
            return out

        cum = None
        if pre_edges is not None:
            cum = pre_cum
            if cum[-1] == cd.n_pairs:
                raise SweepSaturated("Boundary range includes all points")
        elif est_cum is None:
            cum = run_exact_counts()

        def pick_o_star(bound):
            """Largest offset whose (estimated-with-margin or exact)
            count fits under `bound`."""
            if cum is not None:
                ok = np.nonzero(cum <= bound)[0]
            else:
                ok = np.nonzero(est_cum + est_margin <= bound)[0]
            if len(ok) == 0:
                raise SweepSaturated(
                    f"first sweep offset already holds "
                    f"{int((cum if cum is not None else est_cum)[0])} "
                    f"pairs (> max_sweep_fetch {bound})")
            return int(ok.max())

        # the host cap bounds host fetches; the device path covers at
        # least as much, extending to >= 10 scoreable offsets within its
        # HBM budget (the sweep needs enough offsets to bracket the
        # optimum — 3 scored offsets at 81920 collapsed the clustering;
        # the fill's cost is enumeration-dominated so the extra coverage
        # is nearly free, while sweeping ALL the way to the HBM cap is
        # slower: scoring gathers scale with the pair count and
        # the widest offsets are never optimal)
        if dev_possible:
            base = (cum if cum is not None else est_cum + est_margin)
            eff_cap = max(max_sweep_fetch,
                          int(base[min(9, n_grid - 1)]) + 1)
            eff_cap = min(eff_cap, cap_budget)
        else:
            eff_cap = max_sweep_fetch
        o_star = pick_o_star(eff_cap)
        if pre_edges is not None:
            # cap the scored range to the prefilled band: wider offsets
            # the exact counts would admit are never optimal (they score
            # worst-case 1) — if the argmin lands at the band edge the
            # widen loop below refills exactly, as without a bootstrap
            o_star = min(o_star, pre_nact - 1)
        use_sparse_dev = (
            dev_possible
            and (pre_edges is not None  # already resident: proven to fit
                 or hbm_feasible(
                     n_pad,
                     int((cum if cum is not None
                          else est_cum + est_margin)[o_star]), resident)))
        if dev_possible and not use_sparse_dev and eff_cap > max_sweep_fetch:
            # device cap chosen but the buffer doesn't actually fit:
            # fall back to the host path's own cap coherently
            eff_cap = max_sweep_fetch
            o_star = pick_o_star(eff_cap)
        if not use_sparse_dev and cum is None:
            # the host engine needs exact counts before fetching
            cum = run_exact_counts()
            o_star = pick_o_star(eff_cap)
        edges = None
        while True:  # o_star strictly widens, so <= n_grid iterations
            t_ph = time.perf_counter()
            if use_sparse_dev and pre_edges is not None \
                    and o_star < pre_nact:
                # bootstrap prefill covers the scored range: no fill
                # work at all this iteration
                edges = pre_edges
                if o_star < n_grid - 1:
                    sys.stderr.write(
                        f"refine: offsets {o_star + 1}..{n_grid - 1} "
                        f"hold {cum[o_star + 1]}..{cum[-1]} pairs "
                        f"(> cap {eff_cap}); scored as 1\n")
                t_sc = time.perf_counter()
                global_s = np.ones(n_grid)
                global_s[:o_star + 1], _ = sweep_scores_sparse_device(
                    edges, t_all[:o_star + 1])
                sys.stderr.write(
                    f"refine: bootstrap prefill {edges.count} pairs "
                    f"(fill paid in pass 1), device score "
                    f"{time.perf_counter() - t_sc:.1f}s\n")
            elif use_sparse_dev:
                e_total = int((cum if cum is not None
                               else est_cum + est_margin)[o_star])
                # drop the previous iteration's edge buffers BEFORE the
                # refill so two full sets are never resident at once
                # (hbm_feasible budgets one)
                edges = None
                pre_edges = None
                prefill = None  # last ref to the bootstrap band buffers
                try:
                    edges, cum_exact = sweep_fill_device(
                        cd, scale, s_range, slope, *line,
                        n_act=o_star + 1, e_total=e_total,
                        e_per_dev=(per_dev_cum[:, o_star]
                                   if per_dev_cum is not None else None))
                except SweepFillOverflow as e:
                    # the subsample estimate under-sized the buffer: pay
                    # for the exact counts pass it skipped, re-pick the
                    # range, and refill sized exactly
                    sys.stderr.write(f"refine: {e}; falling back to the "
                                     "exact counts pass\n")
                    cum = run_exact_counts()
                    o_star = pick_o_star(eff_cap)
                    if not hbm_feasible(n_pad, int(cum[o_star]),
                                        resident):
                        # exact counts push the buffer past HBM: take
                        # the host path's cap coherently
                        use_sparse_dev = False
                        eff_cap = max_sweep_fetch
                        o_star = pick_o_star(eff_cap)
                        continue
                    edges, cum_exact = sweep_fill_device(
                        cd, scale, s_range, slope, *line,
                        n_act=o_star + 1, e_total=int(cum[o_star]),
                        e_per_dev=(per_dev_cum[:, o_star]
                                   if per_dev_cum is not None else None))
                cum = cum_exact
                if cum[-1] == cd.n_pairs:
                    raise SweepSaturated(
                        "Boundary range includes all points")
                if o_star < n_grid - 1:
                    sys.stderr.write(
                        f"refine: offsets {o_star + 1}..{n_grid - 1} "
                        f"hold {cum[o_star + 1]}..{cum[-1]} pairs "
                        f"(> cap {eff_cap}); scored as 1\n")
                t_sc = time.perf_counter()
                global_s = np.ones(n_grid)
                global_s[:o_star + 1], _ = sweep_scores_sparse_device(
                    edges, t_all[:o_star + 1])
                sys.stderr.write(
                    f"refine: device fill {edges.count} pairs "
                    f"{t_sc - t_ph:.1f}s, device score "
                    f"{time.perf_counter() - t_sc:.1f}s\n")
            else:
                if o_star < n_grid - 1:
                    sys.stderr.write(
                        f"refine: offsets {o_star + 1}..{n_grid - 1} "
                        f"hold {cum[o_star + 1]}..{cum[-1]} pairs "
                        f"(> max_sweep_fetch {eff_cap}); scored as 1\n")
                i, j, idx, d0 = sweep_first_offsets(
                    cd, scale, s_range, slope, *line, _n_act=o_star + 1)
                t_sc = time.perf_counter()
                global_s = np.ones(n_grid)
                global_s[:o_star + 1] = grow_network_scores(
                    cd.n, i, j, idx, o_star + 1, score_idx,
                    betweenness_sample, rng=rng)
                sys.stderr.write(
                    f"refine: fetch {len(i)} pairs {t_sc - t_ph:.1f}s, "
                    f"score {time.perf_counter() - t_sc:.1f}s\n")
            if timings_out is not None:
                key = "fill" if use_sparse_dev else "fetch"
                timings_out[key] = (timings_out.get(key, 0.0)
                                    + t_sc - t_ph)
                timings_out["score"] = (timings_out.get("score", 0.0)
                                        + time.perf_counter() - t_sc)
            min_idx = int(np.argmin(global_s))
            # the local bracket reaches min_idx + 1: widen the fetch if
            # the argmin sits at the cap edge (pairs there must exist
            # for the bounded scalar optimisation and final network)
            if min_idx < o_star or o_star == n_grid - 1:
                break
            need = min(min_idx + 1, n_grid - 1)
            widen_cap = (eff_cap if use_sparse_dev
                         else 2 * max_sweep_fetch)
            if cum[need] > widen_cap:
                raise SweepSaturated(
                    "sweep optimum sits in an offset denser than "
                    "the max_sweep_fetch headroom — lower max_move")
            o_star = need
    global_s[np.isnan(global_s)] = 1
    min_idx = int(np.argmin(global_s))

    if no_local:
        s_opt = float(s_range[min_idx])
    elif 0 < min_idx < n_grid - 1 and edges is not None:
        # device micro-grid: the same flat 147-point level as the host
        # path, scored on device from the resident edge list — the
        # active set at each sub-threshold is a prefix of the d0-sorted
        # edges, so the whole level is one planned sparse sweep
        from .ops.sparse_sweep import sweep_scores_sparse_device

        lo, hi = s_range[min_idx - 1], s_range[min_idx + 1]
        s_opt, best = float(s_range[min_idx]), global_s[min_idx]
        t_ph = time.perf_counter()
        sub_s = np.linspace(lo, hi, 149)[1:-1]
        t_sub = np.maximum.accumulate([
            offset_threshold(float(s), s_range, slope, *line)
            for s in sub_s])
        scores, _ = sweep_scores_sparse_device(edges, t_sub)
        k_min = int(np.argmin(scores))
        if scores[k_min] < best:
            best, s_opt = scores[k_min], float(sub_s[k_min])
        sys.stderr.write(
            f"refine: device micro-grid "
            f"{time.perf_counter() - t_ph:.1f}s\n")
        if timings_out is not None:
            timings_out["local"] = (timings_out.get("local", 0.0)
                                    + time.perf_counter() - t_ph)
    elif 0 < min_idx < n_grid - 1 and cd.buf is None:
        # micro-grid local refinement: the native engine scores a whole
        # offset grid in ONE incremental pass, so bisection levels cost
        # passes over the edge set instead of ~15 sequential Brent
        # evaluations of the same cost each (Brent dominated the refine
        # at 65k genomes). For score_idx 0 the
        # call cost is dominated by the triangle enumeration, which is
        # INDEPENDENT of the offset count — one flat 147-point level
        # (resolution ~ 2-level bisection's grid_step/73) costs ONE
        # enumeration instead of two. Betweenness scoring (idx 1/2) IS
        # per-offset, so bisection stays cheaper there.
        from .network.incremental import grow_network_scores

        lo, hi = s_range[min_idx - 1], s_range[min_idx + 1]
        s_opt, best = float(s_range[min_idx]), global_s[min_idx]
        t_ph = time.perf_counter()
        levels = ((149,) if score_idx == 0 else (18, 18))
        for n_sub in levels:
            sub_s = np.linspace(lo, hi, n_sub)[1:-1]
            t_sub = np.maximum.accumulate([
                offset_threshold(float(s), s_range, slope, *line)
                for s in sub_s])
            # cheap pre-filter: never-active pairs would be dropped by
            # the scorer anyway (both engines); skip the searchsorted
            keep = d0 <= t_sub[-1]
            idx2 = np.searchsorted(t_sub, d0[keep],
                                   side="left").astype(np.int32)
            scores = grow_network_scores(cd.n, i[keep], j[keep], idx2,
                                         len(sub_s), score_idx,
                                         betweenness_sample, rng=rng)
            k_min = int(np.argmin(scores))
            if scores[k_min] < best:
                best, s_opt = scores[k_min], float(sub_s[k_min])
            lo = sub_s[k_min - 1] if k_min > 0 else lo
            hi = sub_s[k_min + 1] if k_min < len(sub_s) - 1 else hi
        sys.stderr.write(
            f"refine: micro-grid {time.perf_counter() - t_ph:.1f}s\n")
        if timings_out is not None:
            timings_out["local"] = (timings_out.get("local", 0.0)
                                    + time.perf_counter() - t_ph)
    elif 0 < min_idx < n_grid - 1:
        if use_matmul:
            def local_score(s_val):
                t_s = offset_threshold(float(s_val), s_range, slope, *line)
                return matmul_sweep_scores(d0_sq, [t_s])[0][0]
        else:
            from .network.incremental import grow_network_scores

            def local_score(s_val):
                t_s = offset_threshold(float(s_val), s_range, slope, *line)
                mask = d0 <= t_s
                return grow_network_scores(
                    cd.n, i[mask], j[mask],
                    np.zeros(int(mask.sum()), np.int32), 1, score_idx,
                    betweenness_sample, rng=rng)[0]

        lo, hi = s_range[min_idx - 1], s_range[min_idx + 1]
        res = scipy.optimize.minimize_scalar(
            local_score, bounds=[lo, hi], method="Bounded",
            options={"disp": False})
        s_opt = float(res.x)
    else:
        s_opt = float(s_range[min_idx])

    coor = transform_line(s_opt, mean0, mean1)
    if slope == 2:
        optimal_x, optimal_y = decision_boundary(coor, gradient)
        if optimal_x < 0 or optimal_y < 0:
            raise RuntimeError(
                "Optimisation produced a boundary outside range")
    else:
        optimal_x, optimal_y = coor[0], coor[1]
        if (slope == 0 and optimal_x < 0) or (slope == 1 and optimal_y < 0):
            raise RuntimeError(
                "Optimisation produced a boundary outside range")
    if use_matmul:
        sweep_data = ("device", d0_sq, s_range, line)
    elif edges is not None:
        sweep_data = ("edges", edges, s_range, line)
    else:
        sweep_data = ("sparse", i, j, idx, d0, s_range, line)
    return optimal_x, optimal_y, s_opt, sweep_data


def _mesh_compact_pass(mesh, planes, lengths, freqs, chunk, n_pad,
                       fold_kwargs, pair_fn, n_payload, bytes_per_pair):
    """Run a compaction pass row-sharded over the mesh: ``pair_fn`` maps
    each chunk's raw folded pairs f32[m, 2] to (mask, payloads) and every
    device compacts its own row range. Returns (positions, *payloads)
    concatenated in ascending global row order."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = int(np.prod(list(mesh.shape.values())))
    r_size = mesh.shape["r"]
    half = fold_rows(n_pad)
    if half % n_dev:
        raise ValueError(f"n//2 ({half}) must divide by the device "
                         f"count ({n_dev})")
    half_loc = half // n_dev
    chunk = min(chunk, half_loc)
    if half_loc % chunk:
        raise ValueError(f"per-device rows ({half_loc}) must divide by "
                         f"chunk ({chunk})")
    plan = _dispatch_plan(half_loc, chunk, n_pad,
                          cap_rows=int(1.5e9 / (bytes_per_pair * n_pad)))
    c = int(chunk)

    def make_local(fsteps):
        def local(planes, lengths, freqs, off):
            dev = (jax.lax.axis_index("q") * r_size
                   + jax.lax.axis_index("r"))
            start0 = dev * half_loc + off * c

            def body(_, s_idx):
                folded, _, _ = _fold_block(
                    planes, lengths, freqs, start0 + s_idx * c, c,
                    **fold_kwargs)
                return None, pair_fn(folded.reshape(-1, 2))

            _, (mask, *payloads) = jax.lax.scan(
                body, None, jnp.arange(fsteps, dtype=jnp.int32))
            mask = mask.reshape(-1)
            m = mask.shape[0]
            pos = jnp.sort(jnp.where(mask,
                                     jnp.arange(m, dtype=jnp.int32), m))
            safe = jnp.clip(pos, 0, m - 1)
            return ((pos[None],)
                    + tuple(jnp.take(p.reshape(-1), safe)[None]
                            for p in payloads)
                    + (mask.sum()[None],))

        return jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(rep,) * 4,
            out_specs=(sh2,) * (1 + n_payload) + (sh1,), check_vma=False))

    rep = P()
    sh1 = P(("q", "r"))
    sh2 = P(("q", "r"), None)
    fns = {}
    rep_sh = NamedSharding(mesh, P())
    with mesh:
        planes = jax.device_put(jnp.asarray(planes), rep_sh)
        lengths = jax.device_put(jnp.asarray(lengths), rep_sh)
        freqs = jax.device_put(jnp.asarray(freqs), rep_sh)
        outs = {}
        for gi, (off, fsteps) in enumerate(plan):
            if fsteps not in fns:
                fns[fsteps] = make_local(int(fsteps))
            m_loc = fsteps * c * (n_pad - 1)
            res = fns[fsteps](planes, lengths, freqs, jnp.int32(off))
            pos, payloads, counts = res[0], res[1:-1], res[-1]
            counts_h = np.asarray(counts)
            for d in range(n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                base = (d * half_loc + off * c) * (n_pad - 1)
                outs[(d, gi)] = (
                    (np.asarray(pos[d, :b][:k], np.int64) + base,)
                    + tuple(np.asarray(p[d, :b][:k]) for p in payloads))
    rows = [outs[key] for key in sorted(outs)]
    if not rows:
        return (np.zeros(0, np.int64),) + tuple(
            np.zeros(0) for _ in range(n_payload))
    return tuple(np.concatenate(cols) for cols in zip(*rows))


def _resolve_shard_planes(shard_planes, mesh, n, klist, ss64, bbits,
                          chunk, knn):
    """ONE home for the column-sharding policy: "auto" switches when the
    REPLICATED planes would crowd a device (memory_plan's
    replicated_planes_max) and the genome axis divides the mesh."""
    if shard_planes != "auto":
        return bool(shard_planes)
    if mesh is None:
        return False
    n_dev = int(np.prod(list(mesh.shape.values())))
    acct = streaming_hbm_accounting(n, klist, ss64, bbits, chunk, knn,
                                    n_dev, shard_planes=False)
    return (acct["planes"] > memory_plan().replicated_planes_max
            and n % n_dev == 0)


def _col_compact_pass(mesh, planes, lengths, freqs, chunk, n_pad,
                      fold_kwargs, pair_fn, n_payload, bytes_per_pair):
    """Column-sharded twin of _mesh_compact_pass: the planes split over
    the genome axis (replicated residency would overflow HBM past ~100k
    genomes); every device walks all folded chunks and compacts its
    column slice. Returns (i, j, *payloads) grouped by owning device —
    callers needing a specific pair order sort (qc lexsorts already)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = int(np.prod(list(mesh.shape.values())))
    half = fold_rows(n_pad)
    if n_pad % n_dev:
        raise ValueError(f"n ({n_pad}) must be a multiple of the device "
                         f"count ({n_dev})")
    n_loc = n_pad // n_dev
    c = max(1, min(chunk, half))
    while half % c:
        c //= 2
    cs = _ColShardedStream(
        mesh, n_pad, n_loc, c, 1, fold_kwargs["klist"],
        fold_kwargs["sketchsize64"], fold_kwargs["bbits"],
        fold_kwargs["pad_bits"], 0, fold_kwargs["use_pallas"],
        fold_kwargs.get("n_real"))
    rep = NamedSharding(mesh, P())
    shp = NamedSharding(mesh, P(None, None, ("q", "r"), None))
    plan = _dispatch_plan(half, c, n_loc,
                          cap_rows=int(1.5e9 / (2 * bytes_per_pair
                                                * n_loc)))
    fns = {}
    outs = {}
    with mesh:
        planes = jax.device_put(jnp.asarray(planes), shp)
        lengths = jax.device_put(jnp.asarray(lengths), rep)
        freqs = jax.device_put(jnp.asarray(freqs), rep)
        for gi, (off, fsteps) in enumerate(plan):
            if fsteps not in fns:
                fns[fsteps] = cs.make_compact(pair_fn, n_payload,
                                              int(fsteps))
            m_loc = fsteps * 2 * c * n_loc
            res = fns[fsteps](planes, lengths, freqs, jnp.int32(off))
            pos, payloads, counts = res[0], res[1:-1], res[-1]
            counts_h = np.asarray(counts)
            for d in range(n_dev):
                k = int(counts_h[d])
                if k == 0:
                    continue
                b = min(_bucket_pow2(k), m_loc)
                ii, jj = _col_decode(
                    np.asarray(pos[d, :b][:k], np.int64), off, c, n_loc,
                    n_pad, d)
                outs[(d, gi)] = (ii, jj) + tuple(
                    np.asarray(p[d, :b][:k]) for p in payloads)
    rows = [outs[key] for key in sorted(outs)]
    if not rows:
        z = np.zeros(0, np.int32)
        return (z, z) + tuple(np.zeros(0)
                              for _ in range(n_payload))
    return tuple(np.concatenate(cols) for cols in zip(*rows))


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "use_pallas",
                                   "n_real", "check_zero"))
def _stream_qc_group(planes, lengths, freqs, s0, max_pi, max_a, c, steps,
                     klist, sketchsize64, bbits, pad_bits, use_pallas,
                     n_real=None, check_zero=True):
    """Compact the pairs failing distance QC (too-long core/accessory or
    zero in either column) from `steps` folded chunks. Returns
    (pos, flags bitmask 1=long 2=zero, count). Pad pairs (+inf) are
    excluded by the isfinite gate. check_zero=False (prop_zero >= 1,
    rule disabled) skips zero-pair compaction — clonal populations hold
    O(n_pairs) zero pairs, which would swamp max_fetch for nothing."""

    def body(_, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        d = folded.reshape(-1, 2)
        core, acc = d[:, 0], d[:, 1]
        finite = jnp.isfinite(core)
        long_bad = finite & ((core > max_pi) | (acc > max_a))
        flags = long_bad.astype(jnp.uint8)
        if check_zero:
            zero_bad = finite & ((core == 0) | (acc == 0))
            flags = flags + 2 * zero_bad.astype(jnp.uint8)
        return None, flags

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    _, flags = jax.lax.scan(body, None, starts)
    flags = flags.reshape(-1)
    bad = flags > 0
    m = flags.shape[0]
    pos = jnp.sort(jnp.where(bad, jnp.arange(m, dtype=jnp.int32), m))
    safe = jnp.clip(pos, 0, m - 1)
    return pos, jnp.take(flags, safe), bad.sum()


def qc_bad_pairs_streaming(planes, lengths, freqs, klist, sketchsize64,
                           bbits, chunk, n_real, max_pi_dist, max_a_dist,
                           max_fetch=40_000_000, use_pallas=None,
                           mesh=None, check_zero=True,
                           shard_planes=False):
    """Distance-QC pre-pass over a plane-major population with no O(n^2)
    anywhere: the streaming twin of qc.qc_dist_mat's row scan
    (qcDistMat, PopPUNK/qc.py:295-369 loads the full condensed matrix).

    Returns (i, j, flags) in condensed (i, j) order for every pair that
    is too long (flag bit 1) or has a zero column (bit 2); the caller
    feeds them through qc.prune_edges for the reference's greedy
    bad-node selection. With a mesh, rows shard over the devices."""
    if use_pallas is None:
        use_pallas = use_kernel()
    n_pad = planes.shape[2]
    if mesh is not None:
        _, _, pad_bits = plane_geometry(sketchsize64, bbits)
        mp = jnp.float32(max_pi_dist)
        ma = jnp.float32(max_a_dist)

        def pair_fn(d):
            core, acc = d[:, 0], d[:, 1]
            finite = jnp.isfinite(core)
            flags = (finite & ((core > mp) | (acc > ma))).astype(jnp.uint8)
            if check_zero:
                flags = flags + 2 * (finite & ((core == 0) | (acc == 0))
                                     ).astype(jnp.uint8)
            return flags > 0, flags

        fold_kwargs = dict(
            klist=tuple(int(k) for k in klist),
            sketchsize64=int(sketchsize64), bbits=int(bbits),
            pad_bits=int(pad_bits), knn=1, dist_col=0,
            use_pallas=bool(use_pallas),
            n_real=int(n_real) if n_real < n_pad else None)
        if _resolve_shard_planes(shard_planes, mesh, n_pad, klist,
                                 sketchsize64, bbits, chunk, 1):
            i, j, flags = _col_compact_pass(
                mesh, planes, lengths, freqs, chunk, n_pad, fold_kwargs,
                pair_fn, 1, 6)
            i, j = i.astype(np.int64), j.astype(np.int64)
        else:
            pos, flags = _mesh_compact_pass(
                mesh, planes, lengths, freqs, chunk, n_pad, fold_kwargs,
                pair_fn, 1, 6)
            i, j = fold_inverse(pos, n_pad)
        if len(i) > max_fetch:
            raise RuntimeError(
                f"more than {max_fetch} pairs fail distance QC — the "
                "thresholds reject most of the population; loosen "
                "--max-pi-dist/--max-a-dist")
        order = np.lexsort((j, i))
        return i[order], j[order], flags.astype(np.uint8)[order]
    half = fold_rows(n_pad)
    chunk = min(chunk, half)
    if half % chunk:
        raise ValueError(f"n//2 ({half}) must be a multiple of chunk "
                         f"({chunk})")
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    nr = int(n_real) if n_real < n_pad else None
    klist_t = tuple(int(k) for k in klist)
    pos_out, flag_out = [], []
    total = 0
    # device conversion ONCE, not per dispatch group: jnp.asarray on a
    # host tensor re-uploads multi-GB planes
    planes_d = jnp.asarray(planes)
    lengths_d = jnp.asarray(lengths)
    freqs_d = jnp.asarray(freqs)
    for off, fsteps in _dispatch_plan(half, chunk, n_pad,
                                      cap_rows=int(1.5e9 / (6 * n_pad))):
        s0 = off * chunk
        pos, flags, count = _stream_qc_group(
            planes_d, lengths_d, freqs_d,
            jnp.int32(s0), jnp.float32(max_pi_dist), jnp.float32(max_a_dist),
            int(chunk), int(fsteps), klist_t, int(sketchsize64),
            int(bbits), int(pad_bits), bool(use_pallas), nr,
            check_zero=bool(check_zero))
        k = int(count)
        total += k
        if total > max_fetch:
            raise RuntimeError(
                f"more than {max_fetch} pairs fail distance QC — the "
                "thresholds reject most of the population; loosen "
                "--max-pi-dist/--max-a-dist")
        if k == 0:
            continue
        m = fsteps * chunk * (n_pad - 1)
        b = min(_bucket_pow2(k), m)
        base = s0 * (n_pad - 1)
        pos_out.append(np.asarray(pos[:b][:k], np.int64) + base)
        flag_out.append(np.asarray(flags[:b][:k], np.uint8))
    if not pos_out:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.uint8)
    pos = np.concatenate(pos_out)
    i, j = fold_inverse(pos, n_pad)
    flags = np.concatenate(flag_out)
    # condensed (i asc, j asc) order so prune_edges' stable sort ties
    # break exactly as the host qc_dist_mat path's row order does
    order = np.lexsort((j, i))
    return i[order], j[order], flags[order]


@partial(jax.jit, static_argnames=("c", "steps", "klist", "sketchsize64",
                                   "bbits", "pad_bits", "slope",
                                   "use_pallas", "n_real"))
def _stream_boundary_group(planes, lengths, freqs, s0, scale, bx, by, c,
                           steps, klist, sketchsize64, bbits, pad_bits,
                           slope, use_pallas, n_real=None):
    """Compact the pairs inside ONE fixed boundary (ops/boundary.line_dist
    <= 0, the assign_threshold rule) from `steps` folded chunks."""

    def body(_, s):
        folded, _, _ = _fold_block(planes, lengths, freqs, s, c, klist,
                                   sketchsize64, bbits, pad_bits, 1, 0,
                                   use_pallas, n_real)
        Xs = folded.reshape(-1, 2) / scale
        x, y = Xs[:, 0], Xs[:, 1]
        if slope == 2:
            inside = _inside_2d(x, y, bx, by)
        elif slope == 0:
            inside = x - bx <= 0
        else:
            inside = y - by <= 0
        return None, inside

    starts = s0 + jnp.arange(steps, dtype=jnp.int32) * c
    _, inside = jax.lax.scan(body, None, starts)
    inside = inside.reshape(-1)
    m = inside.shape[0]
    pos = jnp.sort(jnp.where(inside, jnp.arange(m, dtype=jnp.int32), m))
    return pos, inside.sum()


def fetch_within_boundary(planes, lengths, freqs, klist, sketchsize64,
                          bbits, chunk, n_real, scale, bx, by, slope=2,
                          max_fetch=100_000_000, use_pallas=None,
                          mesh=None, shard_planes=False):
    """(i, j) of every pair inside a fixed boundary, streamed from the
    sketches with no O(n^2) tensor — the --use-model path's network
    construction (the reference re-assigns the full host matrix,
    PopPUNK/__main__.py:520-545 via models.py assign). Exactly the
    assign_threshold <= 0 rule on scaled distances. With a mesh, rows
    shard over the devices."""
    if use_pallas is None:
        use_pallas = use_kernel()
    n_pad = planes.shape[2]
    if mesh is not None:
        _, _, pad_bits = plane_geometry(sketchsize64, bbits)
        scale_dev = jnp.asarray(scale, jnp.float32)
        bxd, byd = jnp.float32(bx), jnp.float32(by)

        def pair_fn(dpairs):
            Xs = dpairs / scale_dev
            x, y = Xs[:, 0], Xs[:, 1]
            if slope == 2:
                inside = _inside_2d(x, y, bxd, byd)
            elif slope == 0:
                inside = x - bxd <= 0
            else:
                inside = y - byd <= 0
            return (inside,)

        fold_kwargs = dict(
            klist=tuple(int(k) for k in klist),
            sketchsize64=int(sketchsize64), bbits=int(bbits),
            pad_bits=int(pad_bits), knn=1, dist_col=0,
            use_pallas=bool(use_pallas),
            n_real=int(n_real) if n_real < n_pad else None)
        if _resolve_shard_planes(shard_planes, mesh, n_pad, klist,
                                 sketchsize64, bbits, chunk, 1):
            i, j = _col_compact_pass(
                mesh, planes, lengths, freqs, chunk, n_pad, fold_kwargs,
                pair_fn, 0, 5)
        else:
            (pos,) = _mesh_compact_pass(
                mesh, planes, lengths, freqs, chunk, n_pad, fold_kwargs,
                pair_fn, 0, 5)
            i, j = fold_inverse(pos, n_pad)
        if len(i) > max_fetch:
            raise RuntimeError(
                f"more than {max_fetch} pairs fall inside the boundary — "
                "the model boundary captures most of this population")
        return i.astype(np.int32), j.astype(np.int32)
    half = fold_rows(n_pad)
    chunk = min(chunk, half)
    if half % chunk:
        raise ValueError(f"n//2 ({half}) must be a multiple of chunk "
                         f"({chunk})")
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    nr = int(n_real) if n_real < n_pad else None
    klist_t = tuple(int(k) for k in klist)
    scale_dev = jnp.asarray(scale, jnp.float32)
    pos_out = []
    total = 0
    # device conversion ONCE, not per dispatch group (multi-GB re-upload)
    planes_d = jnp.asarray(planes)
    lengths_d = jnp.asarray(lengths)
    freqs_d = jnp.asarray(freqs)
    for off, fsteps in _dispatch_plan(half, chunk, n_pad,
                                      cap_rows=int(1.5e9 / (5 * n_pad))):
        s0 = off * chunk
        pos, count = _stream_boundary_group(
            planes_d, lengths_d, freqs_d,
            jnp.int32(s0), scale_dev, jnp.float32(bx), jnp.float32(by),
            int(chunk), int(fsteps), klist_t, int(sketchsize64),
            int(bbits), int(pad_bits), int(slope), bool(use_pallas), nr)
        k = int(count)
        total += k
        if total > max_fetch:
            raise RuntimeError(
                f"more than {max_fetch} pairs fall inside the boundary — "
                "the model boundary captures most of this population")
        if k == 0:
            continue
        m = fsteps * chunk * (n_pad - 1)
        b = min(_bucket_pow2(k), m)
        base = s0 * (n_pad - 1)
        pos_out.append(np.asarray(pos[:b][:k], np.int64) + base)
    if not pos_out:
        z = np.zeros(0, np.int32)
        return z, z
    i, j = fold_inverse(np.concatenate(pos_out), n_pad)
    return i.astype(np.int32), j.astype(np.int32)


def multi_refine_device(cd, scale, mean0, mean1, s_max, n_boundary_points,
                        output_prefix, sample_names, score_idx=0,
                        betweenness_sample=100, seed=42,
                        max_sweep_fetch=40_000_000):
    """Cluster outputs at boundary positions from the origin toward the
    optimum (models/refine.multi_refine, PopPUNK/refine.py:249-312) over
    a streaming population: one capped sweep fetch at the optimum's
    boundary, then the native incremental scorer writes
    _boundary{i}_clusters.csv at every offset."""
    from math import sqrt

    from .network.incremental import grow_network_scores

    rng = np.random.default_rng(seed)
    gradient = (mean1[1] - mean0[1]) / (mean1[0] - mean0[0])
    if mean0[1] >= gradient * mean0[0]:
        s_min = -mean0[0] * sqrt(1 + gradient * gradient)
    else:
        s_min = -mean0[1] * sqrt(1 + 1 / (gradient * gradient))
    s_range = np.linspace(s_min, s_max, num=n_boundary_points)
    line = (mean0[0], mean0[1], mean1[0], mean1[1])
    cum = sweep_counts_streaming(cd, scale, s_range, 2, *line)
    if cum[-1] > max_sweep_fetch:
        raise RuntimeError(
            f"optimum boundary holds {cum[-1]} pairs "
            f"(> max_sweep_fetch {max_sweep_fetch})")
    i, j, idx, _ = sweep_first_offsets(cd, scale, s_range, 2, *line)
    grow_network_scores(cd.n, i, j, idx, n_boundary_points, score_idx,
                        betweenness_sample, write_clusters=output_prefix,
                        sample_names=sample_names, rng=rng)


def run_scale_pipeline(n=20480, klist=(13, 16, 19, 22, 25, 28),
                       sketchsize64=156, bbits=14, n_strains=None, chunk=512,
                       knn=5, subsample=None, score_idx=0, seed=2,
                       max_move=0.25, use_pallas=None, synth_kwargs=None,
                       sharded=None, streaming=None,
                       max_sweep_fetch=40_000_000,
                       log=lambda msg: sys.stderr.write(msg)):
    """Full pipeline on a synthetic device population, timing each stage.

    synth -> condensed dists + fused kNN (device) -> BGMM on subsample ->
    refine boundary (device sweep + native scorer) -> network ->
    clusters vs true strains. Returns a dict of stage seconds and
    results; the host never holds an O(n^2) array.

    streaming=None auto-selects StreamingCondensed once the folded
    buffer (4 n^2 bytes / device) passes memory_plan's
    folded_buffer_max; n_strains defaults to 20 up to the 20480 tier, then grows as n/640 so the
    refine optimum's edge count (~n^2 / 2 n_strains) stays fetchable
    under max_sweep_fetch while the within blob remains ~1% of the
    (5n) fit subsample.
    """
    from .models.bgmm import BGMMFit
    from .network.graph import Graph
    from .network.components import connected_components
    from .network.incremental import components_native
    from .synth import synthetic_population_device

    timings = {}
    out = {"n": n, "n_pairs": n * (n - 1) // 2}
    if n_strains is None:
        # past the 20480 tier, scale strains so within-strain pairs
        # (~n^2 / 2S — the refine optimum's edge count) stay ~2e7:
        # fetchable sparse AND still ~1% of the model subsample. Capped
        # at ~100: the planted between-strain divergence range
        # (strain_div 0.015-0.03) holds ~100 separable strains; beyond
        # that their tails collide and no boundary separates them (the
        # 128-strain 81920 fixture measured ARI 0.002 — a fixture
        # artefact, not a pipeline failure; PopPUNK's model presumes
        # bimodal within/between structure)
        n_strains = 20 if n <= 20480 else min(max(20, n // 640), 102)
    if subsample is None:
        # the reference's 100k fit cap is tuned for <= 20k genomes; at
        # n/640 strains the within blob is ~1% of pairs, so the fit
        # sample scales with n to keep ~5 * n / 640 within pairs in it
        subsample = 100_000 if n <= 20480 else 5 * n
    if synth_kwargs is None and n > 20480:
        # separation margins must scale with the strain count: at 100+
        # strains the default ranges' tails collide (closest strain
        # pairs bridge in BOTH core and accessory — measured at 65k:
        # refine genuinely prefers merging them, ARI 0.1). PopPUNK's
        # model presumes separable strains; benching the pipeline means
        # planting a population that HAS the bimodal structure
        synth_kwargs = dict(strain_div=(0.015, 0.03),
                            accessory_strain=(0.55, 0.75))

    t0 = time.perf_counter()
    pop = synthetic_population_device(
        n, klist, sketchsize64, bbits, n_strains=n_strains, seed=seed,
        chunk=max(chunk, min(n, 2048)), **(synth_kwargs or {}))
    jax.block_until_ready(pop.planes)
    timings["synth"] = time.perf_counter() - t0
    log(f"synth: {n} genomes on device in {timings['synth']:.1f}s\n")

    def divide_down(c, rows):
        """Largest value <= c dividing rows (halving walk; 1 always
        divides) — the fill/streaming twins require chunk | rows."""
        c = max(1, min(c, rows))
        while rows % c:
            c //= 2
        return c

    n_dev = len(jax.devices())
    half = n // 2
    if streaming is None:
        streaming = (4.0 * n * n / max(n_dev, 1)
                     > memory_plan().folded_buffer_max)
    if sharded is None:
        sharded = (not streaming and n_dev > 1 and half % n_dev == 0)
    out["streaming"] = bool(streaming)
    bootstrap = False
    t0 = time.perf_counter()
    if streaming:
        from .parallel.mesh import get_mesh

        # per-chunk transients are ~16 bytes * 2c * n * K across the
        # match/correction/fit buffers (memory_plan().chunk_transient)
        c_max = max(32, int(memory_plan().chunk_transient
                            / (2 * n * len(klist) * 16)))
        c_stream = 1 << (c_max.bit_length() - 1)
        mesh = get_mesh() if n_dev > 1 and half % n_dev == 0 else None
        # chunk must divide the per-device rows, not just half
        rows_loc = half // n_dev if mesh is not None else half
        c_stream = divide_down(min(chunk, c_stream), rows_loc)
        if mesh is not None:
            log(f"dists: streaming sharded over {n_dev} devices\n")
        # two-round bootstrap (single-device score_idx 0): model fit
        # from directly-computed subsample distances FIRST, then ONE
        # streaming pass computes dists + kNN + maxima AND fills the
        # refine boundary band — the refine fill's full distance
        # recompute (206 s of the round-4 255 s refine at 65k) never
        # happens
        bootstrap = (mesh is None and score_idx == 0
                     and os.environ.get("POPPUNK_TPU_BOOTSTRAP",
                                        "1") != "0")
        cd = StreamingCondensed(pop.planes, pop.lengths, pop.freqs, klist,
                                sketchsize64, bbits,
                                chunk=c_stream, knn=knn,
                                use_pallas=use_pallas,
                                subsample=(None if bootstrap
                                           else (subsample, seed)),
                                mesh=mesh,
                                shard_planes="auto", defer=bootstrap)
        if cd._col:
            log("dists: column-sharded planes (replicated residency "
                "would crowd per-device HBM)\n")
        log("dists: streaming (no O(n^2) tensor; buffer would be "
            f"{4.0 * n * n / 2**30:.1f} GiB)\n")
        if bootstrap:
            log("dists: deferred — two-round bootstrap (fit on direct "
                "subsample dists, refine fill fused into pass 1)\n")
        else:
            jax.block_until_ready(cd.knn_dist)
    elif sharded:
        cd = fill_condensed_sharded(pop.planes, pop.lengths, pop.freqs,
                                    klist, sketchsize64, bbits,
                                    chunk=divide_down(chunk,
                                                      half // n_dev),
                                    knn=knn, use_pallas=use_pallas)
        log(f"dists: folded buffer sharded over {n_dev} devices\n")
    else:
        cd = fill_condensed_device(pop.planes, pop.lengths, pop.freqs,
                                   klist, sketchsize64, bbits,
                                   chunk=divide_down(chunk, half),
                                   knn=knn, use_pallas=use_pallas)
    if cd.buf is not None:
        jax.block_until_ready(cd.buf)
    if not bootstrap:
        timings["dists+knn"] = time.perf_counter() - t0
        out["pairs_per_s"] = out["n_pairs"] / timings["dists+knn"]
        log(f"dists+knn: {out['n_pairs']} pairs in "
            f"{timings['dists+knn']:.1f}s "
            f"= {out['pairs_per_s'] / 1e6:.1f} Mpairs/s "
            f"(+ kNN k={knn} fused)\n")

    t0 = time.perf_counter()
    if bootstrap:
        sub = cd.subsample_pairs(subsample, seed=seed, block=32768)
    else:
        sub = cd.subsample_pairs(subsample, seed=seed)
    model = BGMMFit("", max_samples=subsample)
    model.fit(sub, max_components=2)
    timings["bgmm"] = time.perf_counter() - t0
    log(f"bgmm: fit on {sub.shape[0]} subsampled pairs in "
        f"{timings['bgmm']:.1f}s\n")

    mean0 = model.means[model.within_label]
    mean1 = model.means[model.between_label]
    if bootstrap:
        # plan the fill band from the subsample fit (host arithmetic;
        # saturation shrinks max_move BEFORE any device pass runs), then
        # run the single fused pass
        while True:
            try:
                fill_spec = plan_sweep_band(
                    cd, model.scale, mean0, mean1, max_move=max_move,
                    max_sweep_fetch=max_sweep_fetch, est_pairs=sub)
                break
            except SweepSaturated as e:
                if max_move / 4 < 1e-3:
                    raise
                max_move /= 4
                log(f"refine: band saturated ({str(e)[:120]}), "
                    f"replanning max_move={max_move}\n")
        t0 = time.perf_counter()
        cd.run_pass1(fill_spec)
        jax.block_until_ready(cd.knn_dist)
        timings["dists+knn"] = time.perf_counter() - t0
        out["pairs_per_s"] = out["n_pairs"] / timings["dists+knn"]
        log(f"dists+knn: {out['n_pairs']} pairs in "
            f"{timings['dists+knn']:.1f}s "
            f"= {out['pairs_per_s'] / 1e6:.1f} Mpairs/s "
            f"(+ kNN k={knn} and "
            f"{'band fill' if fill_spec else 'no fill'} fused)\n")

    t0 = time.perf_counter()
    # the synthetic between-blob has no outliers, so a generous max_move
    # can put every pair inside the widest boundary (the reference-faithful
    # guard in refine_fit_device raises); back off until the sweep bites
    refine_phases = {}
    while True:
        try:
            opt_x, opt_y, s_opt, sweep = refine_fit_device(
                cd, model.scale, mean0, mean1, max_move=max_move,
                score_idx=score_idx, seed=seed,
                max_sweep_fetch=max_sweep_fetch,
                timings_out=refine_phases, est_pairs=sub,
                prefill=(cd.pop_prefill() if bootstrap else None))
            break
        except SweepSaturated as e:
            # only the sweep-geometry errors are retryable; XLA runtime
            # failures (OOM etc.) are plain RuntimeErrors and propagate
            if max_move / 4 < 1e-3:
                raise
            max_move /= 4
            log(f"refine: sweep saturated ({str(e)[:120]}), retrying "
                f"max_move={max_move}\n")
    timings["refine"] = time.perf_counter() - t0
    if refine_phases:
        out["refine_phase_s"] = {k: round(v, 1)
                                 for k, v in refine_phases.items()}
    log(f"refine: boundary ({opt_x * model.scale[0]:.4f}, "
        f"{opt_y * model.scale[1]:.4f}) via {sweep[0]} sweep in "
        f"{timings['refine']:.1f}s\n")

    t0 = time.perf_counter()
    if sweep[0] == "device":
        _, d0_sq, s_range, line = sweep
        t_final = offset_threshold(s_opt, s_range, 2, *line)
        # components by device label propagation; only O(n) labels fetched
        labels, n_edges = components_device(d0_sq, t_final)
        out["n_edges"] = n_edges
    elif sweep[0] == "edges":
        _, edges, s_range, line = sweep
        t_final = offset_threshold(s_opt, s_range, 2, *line)
        # label propagation over the device-resident edge list: only
        # O(n) labels cross the host link
        labels, n_edges = edge_components_device(edges, t_final)
        out["n_edges"] = n_edges
    else:
        _, i, j, idx, d0, s_range, line = sweep
        t_final = offset_threshold(s_opt, s_range, 2, *line)
        mask = d0 <= t_final
        ei, ej = i[mask], j[mask]
        del sweep, i, j, idx, d0, mask  # O(E) sweep buffers
        # native union-find: scipy's COO->CSR components route peaks at
        # ~10x the edge bytes (measured 5.2 GB host RSS at 65k genomes /
        # 36M edges, tripping bench_scale's O(n^2) guard)
        nat = components_native(n, ei, ej)
        if nat is not None:
            labels = nat[0]
        else:
            labels = connected_components(
                Graph(n, np.stack([ei, ej], axis=1)))[0]
        out["n_edges"] = int(ei.shape[0])
        del ei, ej
    timings["network"] = time.perf_counter() - t0
    out["n_clusters"] = int(labels.max()) + 1
    log(f"network: {out['n_edges']} edges, {out['n_clusters']} clusters "
        f"in {timings['network']:.1f}s\n")

    # lineage tier from the fused kNN (rank-k sparse graph components —
    # PopPUNK's lineage clusters, models.py:1110): zero extra distance
    # work, the kNN was accumulated inside the fill/stream pass
    t0 = time.perf_counter()
    rows, cols, _ = cd.knn_sparse()
    nat = components_native(n, rows, cols)
    if nat is not None:
        lin_labels = nat[0]
    else:
        lin_labels = connected_components(
            Graph(n, np.stack([rows, cols], axis=1)))[0]
    timings["lineage"] = time.perf_counter() - t0
    out["n_lineages"] = int(lin_labels.max()) + 1
    log(f"lineage: rank-{cd.knn_col.shape[1]} graph -> "
        f"{out['n_lineages']} lineages in {timings['lineage']:.1f}s\n")

    # cluster quality vs planted strains
    from .utils import adjusted_rand_index

    out["ari"] = adjusted_rand_index(pop.strain, labels)
    out["ari_lineage"] = adjusted_rand_index(pop.strain, lin_labels)
    out["timings"] = timings
    out["total_s"] = sum(timings.values())
    # synth is bench-fixture generation, not pipeline; it is excluded from
    # the pipeline time
    out["pipeline_s"] = out["total_s"] - timings["synth"]
    log(f"ARI vs planted strains: {out['ari']:.4f}; "
        f"pipeline {out['pipeline_s']:.1f}s (+ synth fixture "
        f"{timings['synth']:.1f}s)\n")
    return out
