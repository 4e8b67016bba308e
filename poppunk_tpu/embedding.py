"""Stochastic cluster embedding (SCE / mandrake) in JAX.

The reference shells out to the external C++/CUDA ``SCE.wtsne`` package
(PopPUNK/mandrake.py:67-110): an asynchronous per-edge SGD over a kNN graph
of accessory distances. That access pattern (billions of single-pair
updates) is hostile to accelerators, so this is re-designed as *batched*
SGD under one jit: every step applies the attractive gradient over all kNN
edges at once (segment-sum) and a resampled set of repulsive pairs, with
the same Student-t kernel (learning rate is constant with adaptive
per-coordinate gains, sklearn-style, rather than the reference's linear
eta decay).
maxIter counts single-pair updates for CLI compatibility and is converted
to batched epochs.

Output: a graphviz .dot of node positions named
``<p>_perplexity<P>_accessory_mandrake.dot`` (mandrake.py:62), coordinates
scaled 5x as the reference writes them.
"""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _perplexity_probabilities(dists, perplexity, n_iter=50):
    """Per-row bandwidth calibration: binary-search beta so the conditional
    distribution over the kNN has the requested perplexity (standard t-SNE
    input calibration). dists: [n, k].

    All rows search together on [n, k] arrays — a per-row Python loop is
    interpreter-bound at the scale tier (65k rows x 50 iterations)."""
    n, k = dists.shape
    target = np.log(max(min(perplexity, k - 1), 1))
    d2 = dists.astype(np.float64) ** 2
    beta = np.ones(n)
    beta_lo = np.zeros(n)
    beta_hi = np.full(n, np.inf)
    p = np.full((n, k), 1.0 / k)
    for _ in range(n_iter):
        raw = np.exp(-d2 * beta[:, None])
        s = raw.sum(axis=1)
        ok = s > 0
        p = np.where(ok[:, None], raw / np.maximum(s, 1e-300)[:, None],
                     1.0 / k)
        h = -(p * np.log(p + 1e-12)).sum(axis=1)
        done = np.abs(h - target) < 1e-4
        if done.all():
            break
        high = h > target  # entropy too high -> raise beta
        beta_lo = np.where(high & ~done, beta, beta_lo)
        beta_hi = np.where(~high & ~done, beta, beta_hi)
        beta = np.where(
            done, beta,
            np.where(high,
                     np.where(np.isinf(beta_hi), beta * 2,
                              (beta + beta_hi) / 2),
                     (beta + beta_lo) / 2))
    return p


# Above this many points the dense [n, n] gradient (exact t-SNE repulsion,
# which XLA evaluates as fused elementwise + reductions) gives
# way to sampled repulsion (LargeVis/SCE estimator).
DENSE_LIMIT = 8192


@partial(jax.jit, static_argnames=("n", "epochs"))
def _sce_optimize_dense(key, Pmat, n, epochs, eta0=200.0):
    """Exact t-SNE gradient descent with momentum, adaptive gains and early
    exaggeration (sklearn-style schedule), fully on device under one scan.

    Pmat: dense symmetric affinity matrix [n, n], rows need not be
    normalised (normalised globally here).
    """
    key, init_key = jax.random.split(key)
    Y0 = jax.random.normal(init_key, (n, 2), jnp.float32) * 1e-4
    P = Pmat / jnp.maximum(Pmat.sum(), 1e-12)
    exagg_end = epochs // 4
    eye = jnp.eye(n, dtype=bool)

    def step(carry, it):
        Y, V, gains = carry
        exagg = jnp.where(it < exagg_end, 12.0, 1.0)
        momentum = jnp.where(it < exagg_end, 0.5, 0.8)

        d = Y[:, None, :] - Y[None, :, :]  # [n, n, 2]
        q = 1.0 / (1.0 + (d ** 2).sum(-1))  # [n, n]
        q = jnp.where(eye, 0.0, q)
        Z = jnp.maximum(q.sum(), 1e-12)
        PQ = (exagg * P - q / Z) * q  # [n, n]
        g = 4.0 * (PQ[:, :, None] * d).sum(axis=1)  # dKL/dY

        # adaptive gains (sklearn _gradient_descent)
        same_sign = jnp.sign(g) == jnp.sign(V)
        gains = jnp.clip(
            jnp.where(same_sign, gains * 0.8, gains + 0.2), 0.01, None)
        V = momentum * V - eta0 * gains * g
        Y = Y + V
        Y = Y - Y.mean(0)
        return (Y, V, gains), None

    (Y, _, _), _ = jax.lax.scan(
        step, (Y0, jnp.zeros_like(Y0), jnp.ones_like(Y0)), jnp.arange(epochs)
    )
    return Y


@partial(jax.jit, static_argnames=("n", "epochs", "n_neg"))
def _sce_optimize_sampled(key, I, J, P, n, epochs, n_neg=5, eta0=1.0,
                          gamma=1.0):
    """Sampled-repulsion variant for large n: attraction over the kNN
    edge list, repulsion from per-edge negative samples with BOUNDED
    per-sample forces (the LargeVis/UMAP gradient family, batched).

    Why not the t-SNE q^2/Z Monte-Carlo estimator: its per-sample weight
    carries a 1/Z factor that GROWS as the embedding spreads, so a
    sampled close pair gets an unbounded kick, which spreads the
    embedding further — a measured runaway (clusters never separated,
    spread exploding with epochs). Here every sampled force is clipped
    to +-4 and each point's displacement is averaged over its
    contribution count, so steps stay bounded no matter the geometry.
    Linear eta decay, as the reference wtsne anneals."""
    key, init_key = jax.random.split(key)
    Y0 = jax.random.normal(init_key, (n, 2), jnp.float32) * 1e-2
    w = P / jnp.maximum(P.max(), 1e-12)  # per-edge weight in (0, 1]

    def step(carry, it):
        Y, key = carry
        eta = eta0 * (1.0 - it / epochs)

        # attraction along kNN edges: w * 2q * (y_i - y_j), clipped
        d = Y[I] - Y[J]  # [E, 2]
        d2 = (d ** 2).sum(-1)
        g_att = jnp.clip((w * 2.0 / (1.0 + d2))[:, None] * d, -4, 4)
        g = jnp.zeros_like(Y)
        g = g.at[I].add(-g_att)
        g = g.at[J].add(g_att)

        # repulsion: n_neg fresh negatives per edge, bounded kernel
        key, k1 = jax.random.split(key)
        neg = jax.random.randint(k1, (I.shape[0], n_neg), 0, n)
        dn = Y[I][:, None, :] - Y[neg]
        dn2 = (dn ** 2).sum(-1)
        rep = gamma * 2.0 / ((0.001 + dn2) * (1.0 + dn2))
        g_rep = jnp.clip((w[:, None] * rep)[:, :, None] * dn, -4, 4)
        g = g.at[I].add(g_rep.sum(axis=1))

        # per-point step: average of its (bounded) kicks, not the sum —
        # a hub with many edges must not take a proportionally huge step
        deg = jnp.zeros(n).at[I].add(1.0 + n_neg).at[J].add(1.0)
        Y = Y + eta * g / jnp.maximum(deg, 1.0)[:, None]
        Y = Y - Y.mean(0)
        return (Y, key), None

    (Y, _), _ = jax.lax.scan(step, (Y0, key), jnp.arange(epochs))
    return Y


def sce_embedding_condensed(acc_vec, n, perplexity, knn=50,
                            max_iter=10_000_000, seed=42):
    """2-D SCE embedding straight from a condensed accessory-distance
    vector (no n x n square materialised)."""
    from .ops.sparse_knn import knn_from_condensed

    knn = min(knn, n - 1)
    I, J, dists = knn_from_condensed(acc_vec, n, knn)
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed)


def sce_embedding(acc_mat, perplexity, knn=50, max_iter=10_000_000, seed=42):
    """2-D SCE embedding of a square accessory-distance matrix."""
    from .ops.sparse_knn import get_knn_distances

    n = acc_mat.shape[0]
    knn = min(knn, n - 1)
    I, J, dists = get_knn_distances(acc_mat, knn)
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed)


def _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed):
    P = _perplexity_probabilities(
        np.asarray(dists).reshape(n, knn), perplexity
    ).reshape(-1)

    # reference maxIter counts single-edge updates; we do all E edges/epoch
    # (floor 1 so a small --iter stays an honest speed/quality knob)
    epochs = int(min(max(max_iter // max(len(I), 1), 1), 1000))
    if n <= DENSE_LIMIT:
        Pmat = np.zeros((n, n), dtype=np.float32)
        Pmat[np.asarray(I), np.asarray(J)] += P
        Pmat[np.asarray(J), np.asarray(I)] += P  # symmetrise
        Y = _sce_optimize_dense(
            jax.random.PRNGKey(seed), jnp.asarray(Pmat), n=n, epochs=epochs)
    else:
        Y = _sce_optimize_sampled(
            jax.random.PRNGKey(seed),
            jnp.asarray(I, jnp.int32),
            jnp.asarray(J, jnp.int32),
            jnp.asarray(P, jnp.float32),
            n=n, epochs=epochs,
        )
    return np.asarray(Y)


def generate_embedding(seq_labels, acc_mat, perplexity, out_prefix, overwrite,
                       kNN=50, maxIter=10_000_000, n_threads=1, seed=42,
                       condensed=False):
    """Write the embedding .dot (generate_embedding, mandrake.py:22-120).

    ``acc_mat`` is a square accessory matrix, or with condensed=True the
    condensed i<j vector (no square ever materialised)."""
    mandrake_filename = os.path.join(
        out_prefix,
        os.path.basename(out_prefix)
        + "_perplexity" + str(perplexity) + "_accessory_mandrake.dot",
    )
    if os.path.isfile(mandrake_filename) and not overwrite:
        sys.stderr.write(
            "Mandrake analysis already exists; add --overwrite to replace\n"
        )
        return mandrake_filename

    sys.stderr.write("Running SCE embedding\n")
    if condensed:
        embedding = sce_embedding_condensed(
            np.asarray(acc_mat), len(seq_labels), perplexity, knn=kNN,
            max_iter=maxIter, seed=seed)
    else:
        embedding = sce_embedding(np.asarray(acc_mat), perplexity, knn=kNN,
                                  max_iter=maxIter, seed=seed)
    write_mandrake_dot(seq_labels, embedding, mandrake_filename)
    return mandrake_filename


def embedding_from_knn(I, J, dists, n, knn, perplexity, max_iter=10_000_000,
                       seed=42):
    """2-D SCE embedding straight from a kNN triple — the scale tier's
    entry (poppunk_tpu/scale.py accumulates the accessory kNN inside the
    distance pass, so no square accessory matrix ever exists; the
    reference's mandrake needs one, mandrake.py:60-67)."""
    return _sce_from_knn(I, J, dists, n, knn, perplexity, max_iter, seed)


def write_mandrake_dot(seq_labels, embedding, mandrake_filename):
    """The reference's .dot output (mandrake.py:112-120)."""
    with open(mandrake_filename, "w") as n_file:
        n_file.write("graph G { ")
        for s, seq_label in enumerate(seq_labels):
            n_file.write(
                f'"{seq_label}"[x="{str(5 * float(embedding[s][0]))}"'
                f',y="{str(5 * float(embedding[s][1]))}"]; '
            )
        n_file.write("}\n")
