"""Variational-Bayes Gaussian mixture in JAX.

Device re-design of the reference's sklearn BayesianGaussianMixture fit
(PopPUNK/bgmm.py:38-43: n_components=K, n_init=5, covariance_type='full',
weight_concentration_prior=0.1 (dirichlet-process stick-breaking),
mean_precision_prior=0.1, mean_prior=[0,0]): the same variational
Gaussian-Wishart updates, jitted with a lax.while_loop over EM iterations
and vmapped over the n_init random restarts so all restarts run on device
simultaneously. Works for any dimensionality; PopPUNK uses d=2.

Returned parameters (weights, means, covariances) follow sklearn's
conventions (covariances_ = posterior scale / degrees of freedom) so the
downstream log-likelihood assignment (PopPUNK/bgmm.py:100-174) is directly
comparable.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

# The model's covariances come from these n x K x 2 products of distances
# around 0.01; a reduced-precision default (TF32 on a GPU keeps ~3 decimal
# digits) would move the means and covariances. At these widths exact f32
# costs nothing.
_HIGHEST = jax.lax.Precision.HIGHEST


def _kmeans_init(key, X, mask, k, iters=10):
    """Random-point seeding + masked Lloyd iterations; returns hard
    responsibilities.

    Deliberately simpler than k-means++ (whose per-step weighted
    ``jax.random.choice`` inside fori_loop inside vmap compiles
    pathologically slowly on XLA): with n_init restarts and a 2-D point
    cloud, random seeding + Lloyd converges to the same basins.
    """
    n, d = X.shape
    # valid rows occupy the prefix [0, n_valid); seed only from there
    n_valid = mask.sum()
    idx = jnp.floor(jax.random.uniform(key, (k,)) * n_valid).astype(jnp.int32)
    centers = X[idx]

    def lloyd(_, centers):
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=X.dtype) * mask[:, None]
        counts = onehot.sum(0)
        sums = jnp.matmul(onehot.T, X, precision=_HIGHEST)
        return jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), centers
        )

    centers = jax.lax.fori_loop(0, iters, lloyd, centers)
    d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return jax.nn.one_hot(jnp.argmin(d2, axis=1), k, dtype=X.dtype) * mask[:, None]


def _estimate_params(X, resp, prior):
    """Gaussian-Wishart posterior parameters from responsibilities."""
    beta0, m0, nu0, psi0 = prior
    n, d = X.shape
    nk = resp.sum(0) + 1e-10  # [K]
    xbar = jnp.matmul(resp.T, X, precision=_HIGHEST) / nk[:, None]  # [K, d]
    diff = X[:, None, :] - xbar[None, :, :]  # [n, K, d]
    sk = jnp.einsum("nk,nki,nkj->kij", resp, diff, diff,
                    precision=_HIGHEST) / nk[:, None, None]
    beta_k = beta0 + nk
    m_k = (beta0 * m0[None, :] + nk[:, None] * xbar) / beta_k[:, None]
    nu_k = nu0 + nk
    dm = xbar - m0[None, :]
    psi_k = (
        psi0[None, :, :]
        + nk[:, None, None] * sk
        + (beta0 * nk / beta_k)[:, None, None] * dm[:, None, :] * dm[:, :, None]
    )
    return nk, xbar, beta_k, m_k, nu_k, psi_k


def _log_resp(X, gamma0, nk, beta_k, m_k, nu_k, psi_k):
    """Variational E-step: log responsibilities (unnormalised)."""
    n, d = X.shape
    k = nk.shape[0]

    # E[ln pi] under DP stick-breaking
    a = 1.0 + nk
    b = gamma0 + (jnp.cumsum(nk[::-1])[::-1] - nk)
    ln_v = digamma(a) - digamma(a + b)
    ln_1mv = digamma(b) - digamma(a + b)
    ln_pi = ln_v + jnp.concatenate([jnp.zeros(1), jnp.cumsum(ln_1mv)[:-1]])

    # E[ln |Lambda|] and expected mahalanobis under Wishart posterior
    chol = jnp.linalg.cholesky(psi_k)  # [K, d, d]
    logdet_psi = 2.0 * jnp.log(jnp.diagonal(chol, axis1=1, axis2=2)).sum(-1)
    i = jnp.arange(d)
    ln_lambda = (
        digamma((nu_k[:, None] - i[None, :]) / 2.0).sum(-1)
        + d * jnp.log(2.0)
        - logdet_psi
    )

    diff = X[:, None, :] - m_k[None, :, :]  # [n, K, d]

    # triangular solve vmapped over components
    def maha_one(cholk, diffk):
        y = jax.scipy.linalg.solve_triangular(cholk, diffk.T, lower=True)
        return (y ** 2).sum(0)

    maha = jax.vmap(maha_one, in_axes=(0, 1), out_axes=1)(chol, diff)  # [n, K]

    log_rho = (
        ln_pi[None, :]
        + 0.5 * ln_lambda[None, :]
        - 0.5 * d / beta_k[None, :]
        - 0.5 * nu_k[None, :] * maha
        - 0.5 * d * jnp.log(2 * jnp.pi)
    )
    return log_rho


@partial(jax.jit, static_argnames=("k", "max_iter", "n_init"))
def _fit_vbgmm_padded(key, X, mask, k, gamma0=0.1, beta0=0.1, max_iter=100,
                      tol=1e-3, n_init=5):
    """Fit the VB-GMM on (possibly padded) X; mask[i]=1 for valid rows.

    Returns dict of arrays for the best restart; weights/means/covariances
    follow sklearn's attribute conventions.
    """
    X = jnp.asarray(X, jnp.float32)
    mask = jnp.asarray(mask, jnp.float32)
    n_valid = mask.sum()
    n, d = X.shape
    m0 = jnp.zeros(d, X.dtype)
    nu0 = jnp.float32(d)
    # masked covariance for the prior scale matrix
    mu = (mask[:, None] * X).sum(0) / n_valid
    Xc = (X - mu) * mask[:, None]
    psi0 = (jnp.matmul(Xc.T, Xc, precision=_HIGHEST)
            / jnp.maximum(n_valid - 1.0, 1.0))
    prior = (beta0, m0, nu0, psi0)

    def one_init(key):
        resp0 = _kmeans_init(key, X, mask, k)

        def em_step(state):
            resp, prev_lb, it, _ = state
            params = _estimate_params(X, resp, prior)
            nk, xbar, beta_k, m_k, nu_k, psi_k = params
            log_rho = _log_resp(X, gamma0, nk, beta_k, m_k, nu_k, psi_k)
            log_norm = jax.scipy.special.logsumexp(log_rho, axis=1, keepdims=True)
            new_resp = jnp.exp(log_rho - log_norm) * mask[:, None]
            lb = (log_norm[:, 0] * mask).sum() / n_valid  # per-sample LB proxy
            return new_resp, lb, it + 1, lb - prev_lb

        def cond(state):
            _, _, it, delta = state
            return (it < max_iter) & (jnp.abs(delta) > tol)

        resp, lb, _, _ = jax.lax.while_loop(
            cond, lambda s: em_step(s), (resp0, -jnp.inf, 0, jnp.inf)
        )
        nk, xbar, beta_k, m_k, nu_k, psi_k = _estimate_params(X, resp, prior)
        return lb, nk, m_k, nu_k, psi_k, beta_k

    keys = jax.random.split(key, n_init)
    lbs, nks, m_ks, nu_ks, psi_ks, beta_ks = jax.vmap(one_init)(keys)
    best = jnp.argmax(lbs)
    nk = nks[best]
    # DP stick-breaking expected weights (sklearn's convention)
    a = 1.0 + nk
    b = gamma0 + (jnp.cumsum(nk[::-1])[::-1] - nk)
    tmp = b / (a + b)
    weights = a / (a + b) * jnp.concatenate([jnp.ones(1), jnp.cumprod(tmp[:-1])])
    weights = weights / weights.sum()
    means = m_ks[best]
    covariances = psi_ks[best] / nu_ks[best][:, None, None]
    return {
        "weights": weights,
        "means": means,
        "covariances": covariances,
        "lower_bound": lbs[best],
        "beta": beta_ks[best],
        "nu": nu_ks[best],
    }


def _bucket(n, base=4096):
    """Next padding bucket ≥ n (powers of two × base) so fit_vbgmm compiles
    once per bucket rather than once per dataset size."""
    size = base
    while size < n:
        size *= 2
    return size


def fit_vbgmm(key, X, k, gamma0=0.1, beta0=0.1, max_iter=100, tol=1e-3,
              n_init=5):
    """Host wrapper: pad X to a shape bucket, run the jitted padded fit."""
    import numpy as np

    X = np.asarray(X, np.float32)
    n = X.shape[0]
    nb = _bucket(n)
    Xp = np.zeros((nb, X.shape[1]), np.float32)
    Xp[:n] = X
    mask = np.zeros(nb, np.float32)
    mask[:n] = 1.0
    return _fit_vbgmm_padded(
        key, Xp, mask, k, gamma0=gamma0, beta0=beta0, max_iter=max_iter,
        tol=tol, n_init=n_init,
    )
