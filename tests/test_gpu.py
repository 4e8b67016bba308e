"""Tests that need the card: the bin-match kernel as compiled for the GPU,
the route the dispatcher takes there, the memory plan read from the device,
and float32 products that must not drop to TF32. Each takes the ``gpu``
fixture, so it skips on other backends; chip_smoke.py runs this file on the
card."""

import numpy as np
import pytest


def _planes(nq, nr, K, bbits, ss64, seed):
    from poppunk_tpu.ops.distances import plane_geometry

    w32, wp, pad_bits = plane_geometry(ss64, bbits)
    rng = np.random.default_rng(seed)
    pq = np.zeros((nq, K, bbits, wp), np.uint32)
    pr = np.zeros((nr, K, bbits, wp), np.uint32)
    pq[..., :w32] = rng.integers(0, 2**32, (nq, K, bbits, w32), np.uint32)
    pr[..., :w32] = rng.integers(0, 2**32, (nr, K, bbits, w32), np.uint32)
    pr[: min(nq, nr) // 2] = pq[: min(nq, nr) // 2]
    return pq, pr, pad_bits


@pytest.mark.gpu
@pytest.mark.parametrize("plane_major", [False, True])
@pytest.mark.parametrize("nq,nr,K,bbits,ss64", [
    (3, 5, 3, 5, 17), (64, 128, 3, 5, 17), (65, 129, 5, 14, 156),
    (200, 1000, 6, 14, 156)])
def test_kernel_matches_plain_route(gpu, nq, nr, K, bbits, ss64,
                                    plane_major):
    from poppunk_tpu.ops.distances import match_counts_xla
    from poppunk_tpu.ops.match_kernel import match_counts_triton

    pq, pr, pad_bits = _planes(nq, nr, K, bbits, ss64, nq + nr)
    want = np.asarray(match_counts_xla(pq, pr, pad_bits))
    if plane_major:
        pq, pr = pq.transpose(1, 2, 0, 3), pr.transpose(1, 2, 0, 3)
    got = np.asarray(match_counts_triton(pq, pr, pad_bits,
                                         plane_major=plane_major))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_dispatcher_takes_the_kernel(gpu, monkeypatch):
    from poppunk_tpu.ops import match_kernel

    assert match_kernel.use_kernel() is True
    calls = []
    monkeypatch.setattr(match_kernel, "match_counts_triton",
                        lambda *a, **k: calls.append(k))
    match_kernel.match_counts(np.zeros((1, 1, 1, 4), np.uint32),
                              np.zeros((1, 1, 1, 4), np.uint32), 0)
    assert calls == [{"plane_major": False}]


@pytest.mark.gpu
def test_memory_plan_reads_the_device_limit(gpu):
    import jax

    from poppunk_tpu.memory import memory_plan

    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    plan = memory_plan()
    assert plan.budget == limit
    assert plan.replicated_planes_max == limit // 2


@pytest.mark.gpu
def test_bgmm_m_step_matches_float64(gpu):
    """The BGMM's products run at full f32 precision on the card (TF32
    would move these means and scatter matrices by ~1e-3 relative)."""
    import jax
    import jax.numpy as jnp

    from poppunk_tpu.models.vbgmm import _estimate_params

    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0.01, 0.002, (4000, 2)),
                        rng.normal(0.03, 0.004, (4000, 2))])
    resp = rng.dirichlet(np.ones(2), len(X))
    prior = (0.1, np.zeros(2), 2.0, np.cov(X.T))
    got = jax.jit(_estimate_params)(
        jnp.asarray(X, jnp.float32), jnp.asarray(resp, jnp.float32),
        tuple(jnp.asarray(p, jnp.float32) for p in prior))
    nk = resp.sum(0)
    xbar = resp.T @ X / nk[:, None]
    diff = X[:, None, :] - xbar[None]
    sk = np.einsum("nk,nki,nkj->kij", resp, diff, diff) / nk[:, None, None]
    np.testing.assert_allclose(np.asarray(got[1]), xbar, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[5]) - prior[3][None]
                               - (0.1 * nk / (0.1 + nk))[:, None, None]
                               * (xbar[:, None, :] * xbar[:, :, None]),
                               nk[:, None, None] * sk, rtol=2e-5, atol=1e-9)
