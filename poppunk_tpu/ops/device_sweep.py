"""Boundary sweep scored entirely on device.

Device replacement for the host incremental-network scoring of the
refine search (growNetwork, PopPUNK/refine.py:375-474): instead of growing
one graph and re-scoring it per boundary offset, ALL offsets are scored in
one jit — for each offset t the active-edge adjacency is scattered dense
and the score

    transitivity * (1 - density),
    transitivity = 6*triangles / (2*wedges) = sum(A * (A@A)) / sum(d(d-1))

comes out of a single [n, n] matmul (A * A@A summed gives
6*triangles directly — no A^3 needed). A lax.scan over offsets keeps peak
memory at two [n, n] f32 buffers.

This path covers score_idx = 0 (the default) up to
memory_plan().device_sweep_max_n vertices (dense [n, n] device memory).
Beyond that, and for the betweenness-weighted scores (idx 1/2), the
sparse native engine takes over (native/graph_core.cpp
via network/incremental.py: one O(E^1.5) compact-forward triangle pass +
OpenMP Brandes) — no [n, n] buffers at any n.

Precision: the A@A entries and per-row sums are exact in f32 (< 2^24);
the AGGREGATES (sum deg(deg-1), 6*triangles, 2*edges) can exceed 2^24 on
dense sweep offsets, where XLA's tree reductions leave ~log2(n^2)*eps ~
1e-6 relative error — orders below grid-level score differences, and
exactly zero in the < 2^24 regime the host-oracle equality tests pin.
counts_f32_exact() reports which regime an edge set is in.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..memory import memory_plan


@partial(jax.jit, static_argnames=("n", "n_offsets"))
def _sweep_scores(i_vec, j_vec, idx_vec, n, n_offsets):
    possible = 0.5 * n * (n - 1)

    def score_at(_, t):
        active = (idx_vec <= t).astype(jnp.float32)
        A = jnp.zeros((n, n), jnp.float32)
        # duplicate-safe: max instead of add
        A = A.at[i_vec, j_vec].max(active)
        A = A.at[j_vec, i_vec].max(active)
        deg = A.sum(axis=1)
        n_edges = deg.sum() / 2.0
        density = n_edges / possible
        wedges2 = (deg * (deg - 1.0)).sum()  # 2 * wedges
        # exact at any matmul precision (TF32 or bf16 passes hold 0/1
        # operands exactly; accumulation is f32 and entries are < 2^24)
        paths = (A * jnp.dot(A, A, preferred_element_type=jnp.float32)).sum()
        transitivity = jnp.where(wedges2 > 0, paths / wedges2, 0.0)
        return None, -(transitivity * (1.0 - density))

    _, scores = jax.lax.scan(score_at, None,
                             jnp.arange(n_offsets, dtype=jnp.int32))
    return scores


def _bucket(k):
    b = 1
    while b < k:
        b *= 2
    return b


def sweep_scores_device(n_vertices, i_vec, j_vec, idx_vec, n_offsets):
    """-(score) per offset, matching grow_network_scores with score_idx=0.

    i_vec/j_vec/idx_vec: edges with the first offset index at which each
    becomes active (the thresholdIterate output). Edge arrays are padded
    to power-of-two buckets (pad edges carry idx = n_offsets, never
    active) so the unconstrained search's 20 differently-sized rows
    share a handful of compiled programs instead of one 20-70 s remote
    compile each.
    """
    if len(i_vec) == 0:
        # the host twin's empty-network score: transitivity 0 -> -0.0
        return np.zeros(n_offsets)
    e = len(i_vec)
    b = _bucket(e)
    # int32 host-side BEFORE upload: int64 doubles the H2D bytes
    iv = np.zeros(b, np.int32)
    jv = np.zeros(b, np.int32)
    xv = np.full(b, n_offsets, np.int32)  # pad edges: never active
    iv[:e] = np.asarray(i_vec, dtype=np.int32)
    jv[:e] = np.asarray(j_vec, dtype=np.int32)
    xv[:e] = np.asarray(idx_vec, dtype=np.int32)
    scores = _sweep_scores(jnp.asarray(iv), jnp.asarray(jv),
                           jnp.asarray(xv), int(n_vertices), int(n_offsets))
    return np.asarray(scores, dtype=np.float64)


# f32 accumulations are exact only below 2^24; every aggregate the score
# needs (2*edges, sum deg(deg-1), 6*triangles) must stay under it.
F32_EXACT = float(2 ** 24)


def counts_f32_exact(i_vec, j_vec, n_vertices):
    """True iff the FINAL graph's aggregate counts are exactly
    representable in f32 — the widest sweep offset activates every edge,
    so this bounds every offset. 6*triangles <= sum over edges of
    min(deg_u, deg_v) <= wedges2, so gating on wedges2 suffices."""
    if len(i_vec) == 0:
        return True
    deg = np.bincount(np.asarray(i_vec, np.int64), minlength=n_vertices)
    deg += np.bincount(np.asarray(j_vec, np.int64), minlength=n_vertices)
    wedges2 = float((deg.astype(np.float64) * (deg - 1.0)).sum())
    return max(wedges2, 2.0 * len(i_vec)) < F32_EXACT


def use_device_sweep(n_vertices, score_idx, i_vec=None, j_vec=None):
    """Route to the dense device sweep: score 0, vertex count within the
    HBM cap, a non-CPU backend. The optional edge list is accepted for
    callers that want to require the < 2^24 exact-aggregate regime, but
    is not gated on by default — past it the tree-reduction error is
    ~1e-6 relative (module docstring), negligible at grid granularity,
    and falling back would forfeit the device sweep for every dense
    offset set."""
    return (score_idx == 0
            and jax.default_backend() != "cpu"
            and n_vertices <= memory_plan().device_sweep_max_n)
