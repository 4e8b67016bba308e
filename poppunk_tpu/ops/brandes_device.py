"""Batched Brandes betweenness on device (matmul formulation).

The refine betweenness scores (score_idx 1/2) need, per evaluated
boundary offset, the max normalised betweenness centrality per network
component of size > 3, from a sampled source subset
(reference: networkSummary + betweenness_sample,
PopPUNK/network.py:1204-1307 and 1279-1285; the host
oracle is network/summary.brandes_betweenness, whose native OpenMP twin
is native/graph_core.cpp).

Matmul formulation: the strain-graph components at refine scale are
a few thousand vertices each — their DENSE adjacency fits [m, m]
tiles — and Brandes' level-synchronous BFS is a sequence of
(adjacency x per-source-vector) products, so a BATCH of components x a
BATCH of sources turns the whole forward sigma recursion and backward
dependency accumulation into einsum('cij,cjs->cis') matmuls.
One jitted while_loop runs all components and all sources to
convergence simultaneously; no per-source Python, no scalar frontier
queues.

Shortest-path counts sigma at these diameters (dense strain blobs,
diameter 2-4) stay far below f32 range; matmuls run at
precision=HIGHEST so sigma (an integer-valued count) is exact and the
dependency ratios match the float64 host oracle to f32 rounding.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["brandes_batched_device", "pack_components"]

_INF = jnp.int32(2 ** 30)


@partial(jax.jit, static_argnames=("exact",))
def _brandes_batched(A, sources, weights, exact=True):
    """A: f32 [C, m, m] symmetric 0/1 dense adjacencies (zero diagonal,
    padded rows/cols all-zero). sources: i32 [C, S], -1 = padding.
    weights: f32 [C, S] per-source contribution weight (the sampling
    rescale n_comp / n_sampled rides here). Returns bc f32 [C, m]:
    unnormalised betweenness (Brandes' undirected double-counting
    convention) summed over the given sources."""
    C, m, _ = A.shape
    S = sources.shape[1]
    prec = lax.Precision.HIGHEST if exact else lax.Precision.DEFAULT

    def dot(mat, vec):  # [C, m, m] x [C, m, S] -> [C, m, S]
        return jnp.einsum("cij,cjs->cis", mat, vec, precision=prec)

    valid = (sources >= 0)[:, None, :]  # [C, 1, S]
    src = jnp.clip(sources, 0, m - 1)
    onehot = jax.nn.one_hot(src, m, axis=1, dtype=jnp.float32) * valid
    dist = jnp.where(onehot > 0, jnp.int32(0), _INF)  # [C, m, S]
    sigma = onehot

    def fwd_cond(state):
        dist, _, level = state
        return jnp.any(dist == level)

    def fwd_body(state):
        dist, sigma, level = state
        frontier = (dist == level).astype(jnp.float32)
        contrib = dot(A, sigma * frontier)
        newly = (contrib > 0) & (dist == _INF)
        dist = jnp.where(newly, level + 1, dist)
        sigma = jnp.where(newly, contrib, sigma)
        return dist, sigma, level + 1

    dist, sigma, n_levels = lax.while_loop(
        fwd_cond, fwd_body, (dist, sigma, jnp.int32(0)))

    def bwd_cond(state):
        _, level = state
        return level >= 1

    def bwd_body(state):
        delta, level = state
        w_mask = (dist == level).astype(jnp.float32)
        inv_sigma = jnp.where(sigma > 0, 1.0 / sigma, 0.0)
        coef = (1.0 + delta) * inv_sigma * w_mask
        pred_mask = (dist == level - 1).astype(jnp.float32)
        delta = delta + sigma * dot(A, coef) * pred_mask
        return delta, level - 1

    delta, _ = lax.while_loop(
        bwd_cond, bwd_body, (jnp.zeros_like(sigma), n_levels - 1))

    reached = (dist > 0) & (dist < _INF)  # excludes source + unreachable
    return (delta * reached * weights[:, None, :]).sum(axis=2)


def brandes_batched_device(A, sources, weights=None, exact=True):
    """Dispatch wrapper; see _brandes_batched. weights default to 1."""
    A = jnp.asarray(A, jnp.float32)
    sources = jnp.asarray(sources, jnp.int32)
    if weights is None:
        weights = jnp.ones(sources.shape, jnp.float32)
    return _brandes_batched(A, sources, jnp.asarray(weights, jnp.float32),
                            exact=bool(exact))


def pack_components(i, j, labels, min_size=4, max_comp=None, pad_to=None):
    """Host-side packing of an edge list into the batched dense layout.

    i, j: edge endpoints (global vertex ids); labels: component label
    per vertex. Components of size <= min_size - 1 are dropped (the
    reference scores only size > 3, network.py:1270). Returns
    (adj [C, m, m] f32, local_of [n] i32 (-1 if dropped), comps
    (list of global-vertex arrays per kept component)) with m the
    largest kept component size rounded up to ``pad_to`` (default:
    next multiple of 128)."""
    labels = np.asarray(labels)
    comps_all, counts = np.unique(labels, return_counts=True)
    keep = comps_all[counts >= min_size]
    if max_comp is not None:
        keep = keep[:max_comp]
    comps = [np.flatnonzero(labels == c) for c in keep]
    if not comps:
        return (np.zeros((0, 0, 0), np.float32),
                np.full(labels.shape, -1, np.int32), [])
    m = max(len(v) for v in comps)
    pad_to = pad_to or 128
    m = ((m + pad_to - 1) // pad_to) * pad_to
    n = labels.shape[0]
    local_of = np.full(n, -1, np.int32)
    comp_of = np.full(n, -1, np.int32)
    for ci, verts in enumerate(comps):
        local_of[verts] = np.arange(len(verts), dtype=np.int32)
        comp_of[verts] = ci
    adj = np.zeros((len(comps), m, m), np.float32)
    ci_e = comp_of[i]
    ok = (ci_e >= 0) & (ci_e == comp_of[j])
    a, b = local_of[i[ok]], local_of[j[ok]]
    adj[ci_e[ok], a, b] = 1.0
    adj[ci_e[ok], b, a] = 1.0
    return adj, local_of, comps
