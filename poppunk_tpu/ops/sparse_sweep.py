"""Sparse boundary-sweep scoring on device at any n.

Replaces the host fetch + native scoring of the refine search for
score_idx 0 (networkSummary's transitivity * (1 - density),
PopPUNK/refine.py:375-474 + network.py:1204-1307) when the vertex count
exceeds the dense matmul sweep's cap (memory_plan().matmul_sweep_max_n):
instead of streaming O(E) in-boundary pairs to the host, the edge list
stays device-resident and every offset is scored on the device against a
bit-packed adjacency.

Core ideas:

* Edges arrive (i, j, d0) with d0 the signed boundary distance; sorted
  by d0 once, every threshold's active set is a PREFIX, and consecutive
  thresholds differ by a contiguous DELTA slice.
* The adjacency is a bit-packed [n, ceil(n/32)] uint32 bitmap (512 MB at
  n = 65536) carried incrementally across thresholds: each step
  scatters only its delta edges (each edge exactly once across the whole
  sweep) and gathers only delta rows for triangle counting — total
  gather traffic is O(E * n/8) per sweep, not per offset.
* New triangles per step are counted exactly by inclusion-exclusion
  over popcounts against the old bitmap, the delta-only bitmap, and
  their union: a new triangle with k in {1,2,3} new edges contributes
  k to S_all = sum popcount(B[u] & B[v]) over new edges, 1 to S_on
  (both other edges old) iff k = 1, and 3 to S_nn (both other edges
  new) iff k = 3, so
      n_new = S_on + (S_all - S_on - S_nn)/2 + S_nn/3.
* Thresholds are grouped by the power-of-two bucket of their delta size
  and each group runs as ONE dispatch scanning its steps with a static
  pad — a handful of compiled programs total, carried bitmap state
  donated between dispatches.

Precision: per-step popcount sums are exact integers in f32 (each
summand < 2^24, per-step totals < ~2^31 with ~1e-7 relative rounding);
the running triangle count accumulates in f32 with the same ~1e-7
relative error — orders below grid-level score differences, matching
the dense sweep's documented tolerance (ops/device_sweep.py).

Oracle: network/incremental.grow_network_scores equality is pinned in
tests/test_sparse_sweep.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..memory import memory_plan

# Static scan lengths are padded to these sizes (zero-count no-op steps)
# so the compiled-program space stays small.
_STEP_GRID = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Delta-slice pads (power-of-two).
_PAD_LO = 1024

# Edge-block size for the triangle popcount gathers: bounds the gathered
# row transient to 4 * _TRI_BLOCK * ceil(n/32) * 4 bytes (537 MB at
# n = 131072).
_TRI_BLOCK = 8192


def _bucket(k, lo=_PAD_LO):
    b = lo
    while b < k:
        b *= 2
    return b


def _steps_bucket(k):
    for s in _STEP_GRID:
        if k <= s:
            return s
    return _STEP_GRID[-1]


@partial(jax.jit, static_argnames=("n", "w", "pad", "steps", "n_real"),
         donate_argnums=(0, 1))
def _delta_sweep_group(bm, deg, tri, nedges, i_sorted, j_sorted, starts,
                       counts, n, w, pad, steps, n_real):
    """Score `steps` ascending thresholds whose active edge sets are
    prefixes of the d0-sorted (i_sorted, j_sorted).

    bm:       uint32[n, w] bit-packed adjacency of every edge already
              activated by previous groups (donated, carried forward).
    deg:      int32[n] degrees so far (donated).
    tri:      f32 triangle count so far.
    nedges:   int32 active edge count so far.
    starts:   int32[steps] prefix offset where each step's delta begins.
    counts:   int32[steps] delta sizes (<= pad; 0 = padding no-op step).

    Returns (bm, deg, tri, nedges, scores[steps], edge_counts[steps]).
    """
    possible = 0.5 * float(n_real) * (n_real - 1.0)
    lane = jnp.arange(pad, dtype=jnp.int32)
    e_alloc = i_sorted.shape[0]

    tblk = min(pad, _TRI_BLOCK)
    nblk = pad // tblk

    def step(carry, sc):
        bm, deg, tri, nedges = carry
        st, ct = sc
        # clamp the slice start so [st2, st2+pad) stays in range, and
        # shift the active-lane window to compensate — the delta lives
        # at lanes [shift, shift+ct). Avoids padding the edge arrays by
        # a whole extra bucket (e_alloc >= bucket(count) >= st + ct
        # guarantees shift + ct <= pad).
        st2 = jnp.minimum(st, e_alloc - pad)
        shift = st - st2
        mask = (lane >= shift) & (lane < shift + ct)
        iv = jnp.where(mask,
                       jax.lax.dynamic_slice(i_sorted, (st2,), (pad,)), n)
        jv = jnp.where(mask,
                       jax.lax.dynamic_slice(j_sorted, (st2,), (pad,)), n)
        bit_j = (jnp.uint32(1) << (jv & 31).astype(jnp.uint32))
        bit_i = (jnp.uint32(1) << (iv & 31).astype(jnp.uint32))
        zero = jnp.uint32(0)
        # delta-only bitmap: edges are unique pairs, so every target bit
        # is written at most once and add == bitwise-or
        bnew = jnp.zeros((n, w), jnp.uint32)
        bnew = bnew.at[iv, jv >> 5].add(jnp.where(mask, bit_j, zero),
                                        mode="drop")
        bnew = bnew.at[jv, iv >> 5].add(jnp.where(mask, bit_i, zero),
                                        mode="drop")

        safe_i = jnp.clip(iv, 0, n - 1)
        safe_j = jnp.clip(jv, 0, n - 1)

        # triangle popcount sums over tblk-edge blocks: gathering all
        # pad rows at once would materialise [pad, w] x4 (terabytes at
        # multi-million-edge deltas); blocks bound the transient to
        # 4 * tblk * w * 4 bytes
        def tri_block(b, acc):
            s_all, s_on, s_nn = acc
            bsl = lambda a: jax.lax.dynamic_slice_in_dim(a, b * tblk,
                                                         tblk)
            ib, jb, mb = bsl(safe_i), bsl(safe_j), bsl(mask)
            bou = bm[ib]
            bov = bm[jb]
            bnu = bnew[ib]
            bnv = bnew[jb]

            def psum(x, y):
                pc = jax.lax.population_count(x & y).sum(axis=1)
                return jnp.where(mb, pc, 0).astype(jnp.float32).sum()

            return (s_all + psum(bou | bnu, bov | bnv),
                    s_on + psum(bou, bov),
                    s_nn + psum(bnu, bnv))

        s_all, s_on, s_nn = jax.lax.fori_loop(
            0, nblk, tri_block, (jnp.float32(0), jnp.float32(0),
                                 jnp.float32(0)))
        tri = tri + s_on + 0.5 * (s_all - s_on - s_nn) + s_nn / 3.0

        bm = bm | bnew
        deg = deg.at[safe_i].add(mask.astype(jnp.int32)) \
                 .at[safe_j].add(mask.astype(jnp.int32))
        # pad vertex rows (>= n_real) never receive edges, so deg there
        # stays 0 and the wedge sum is over real vertices only
        degf = deg.astype(jnp.float32)
        wedges2 = (degf * (degf - 1.0)).sum()
        nedges = nedges + ct
        density = nedges.astype(jnp.float32) / possible
        trans = jnp.where(wedges2 > 0, 6.0 * tri / wedges2, 0.0)
        score = -(trans * (1.0 - density))
        return (bm, deg, tri, nedges), (score, nedges)

    (bm, deg, tri, nedges), (scores, edge_counts) = jax.lax.scan(
        step, (bm, deg, tri, nedges), (starts, counts))
    return bm, deg, tri, nedges, scores, edge_counts


@partial(jax.jit, donate_argnums=(0, 1, 2))
def _sort3(d0, i, j):
    return jax.lax.sort((d0, i, j), num_keys=1)


class SweepEdges:
    """Device-resident in-boundary edge list (i, j, d0), d0-sorted.

    i/j are int32 with value `n` marking pad slots; d0 pads are +inf.
    Construction sorts once on device; `counts_at` answers prefix sizes
    for any ascending threshold grid with one tiny dispatch.
    """

    def __init__(self, i_dev, j_dev, d0_dev, count, n, n_real=None):
        self.n = int(n)
        self.n_real = int(n_real) if n_real is not None else int(n)
        self.count = int(count)
        # the delta kernel dynamic-slices pad-sized windows with the
        # start clamped into range (lane window shifted to compensate);
        # the arrays only need one pad-granule of headroom: bucket(count)
        # >= count covers every start + delta
        need = _bucket(max(self.count, 1))
        if i_dev.shape[0] < need:
            extra = need - i_dev.shape[0]
            i_dev = jnp.concatenate(
                [i_dev, jnp.full(extra, n, i_dev.dtype)])
            j_dev = jnp.concatenate(
                [j_dev, jnp.full(extra, n, j_dev.dtype)])
            d0_dev = jnp.concatenate(
                [d0_dev, jnp.full(extra, jnp.inf, d0_dev.dtype)])
        # donated sort: inputs alias outputs where XLA can, halving the
        # in+out residency of the largest transient phase
        d0s, i_s, j_s = _sort3(d0_dev, i_dev, j_dev)
        self.d0 = d0s
        self.i = i_s
        self.j = j_s

    def __len__(self):
        return self.count

    def counts_at(self, thresholds):
        """Active-prefix length per ascending threshold (host int64[])."""
        t = jnp.asarray(np.asarray(thresholds, np.float32))
        pos = jnp.searchsorted(self.d0, t, side="right")
        return np.minimum(np.asarray(pos, np.int64), self.count)

    def fetch_prefix(self, k):
        """Host (i, j) of the first k edges (the final-network fetch at
        the optimal boundary; int32, ~8 bytes/pair)."""
        k = int(k)
        if k == 0:
            z = np.zeros(0, np.int32)
            return z, z
        b = min(_bucket(k), self.i.shape[0])
        return (np.asarray(self.i[:b][:k], np.int32),
                np.asarray(self.j[:b][:k], np.int32))


def sweep_scores_sparse_device(edges, thresholds):
    """-(transitivity * (1 - density)) per ascending threshold, scored
    entirely on device from a SweepEdges list. O(len(thresholds)) ints
    cross the host link; the edge list never does.

    Host twin: network/incremental.grow_network_scores with
    score_idx=0 over (i, j, searchsorted(thresholds, d0)).
    """
    n = edges.n
    w = (n + 31) // 32
    ts = np.asarray(thresholds, np.float64)
    if np.any(np.diff(ts) < 0):
        raise ValueError("thresholds must be ascending")
    cum = edges.counts_at(ts)
    deltas = np.diff(np.concatenate([[0], cum]))

    # plan: consecutive runs sharing a delta bucket, scan length padded
    # to the step grid with zero-count no-op steps
    pad_cap = _bucket(max(edges.count, 1))
    groups = []
    s = 0
    while s < len(ts):
        pad = min(_bucket(int(deltas[s])), pad_cap)
        e = s + 1
        while (e < len(ts) and min(_bucket(int(deltas[e])), pad_cap) == pad
               and e - s < _STEP_GRID[-1]):
            e += 1
        groups.append((s, e, pad))
        s = e

    bm = jnp.zeros((n, w), jnp.uint32)
    deg = jnp.zeros(n, jnp.int32)
    tri = jnp.float32(0.0)
    nedges = jnp.int32(0)
    scores = np.ones(len(ts), np.float64)
    counts_out = np.zeros(len(ts), np.int64)
    starts_all = np.concatenate([[0], cum[:-1]]).astype(np.int32)
    for (s, e, pad) in groups:
        steps = _steps_bucket(e - s)
        st = np.zeros(steps, np.int32)
        ct = np.zeros(steps, np.int32)
        st[:e - s] = starts_all[s:e]
        ct[:e - s] = deltas[s:e]
        bm, deg, tri, nedges, sc, ec = _delta_sweep_group(
            bm, deg, tri, nedges, edges.i, edges.j,
            jnp.asarray(st), jnp.asarray(ct), n, w, int(pad), int(steps),
            edges.n_real)
        scores[s:e] = np.asarray(sc, np.float64)[:e - s]
        counts_out[s:e] = np.asarray(ec, np.int64)[:e - s]
    return scores, counts_out


# fill-phase streaming transients (plan-capped compaction buffers)
FILL_TRANSIENT = 1_500_000_000


def hbm_feasible(n, e_cap, resident_bytes):
    """True if a sweep over e_cap edges fits alongside `resident_bytes`
    of persistent tensors (planes / condensed buffer) at EVERY phase:

    - fill: resident + compaction transients + 12 B/slot edge buffers;
    - d0-sort: resident + ~2x the edge buffers (in + out; inputs are
      donated but XLA still needs workspace);
    - scoring: resident + edge buffers + two [n, n/32] bitmaps +
      gather blocks.

    Slots are pow2-bucketed, so up to 2x e_cap."""
    slots = _bucket(max(e_cap, 1))
    w = (n + 31) // 32
    bitmaps = 2 * n * w * 4  # carried adjacency + per-step delta bitmap
    tri_gather = 4 * _TRI_BLOCK * w * 4
    fill = resident_bytes + FILL_TRANSIENT + 12 * slots
    sort = resident_bytes + 24 * slots
    score = resident_bytes + 12 * slots + bitmaps + tri_gather \
        + 200_000_000
    return max(fill, sort, score) <= memory_plan().sweep_total


def max_edge_cap(n, resident_bytes):
    """Largest pow2 edge count hbm_feasible accepts (0 if none)."""
    cap = 0
    c = 1 << 20
    while hbm_feasible(n, c, resident_bytes):
        cap = c
        c *= 2
    return cap
