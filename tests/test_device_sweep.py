"""Device boundary sweep must match the host incremental scoring exactly
(score_idx=0) — the kernel-oracle pattern applied to the refine path."""

import numpy as np
import pytest

from poppunk_tpu.network.incremental import grow_network_scores
from poppunk_tpu.ops.device_sweep import sweep_scores_device


def random_sweep(n, n_offsets, n_edges, seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n - 1, n_edges)
    j = rng.integers(1, n, n_edges)
    swap = i >= j
    i2 = np.where(swap, j, i)
    j2 = np.where(swap, np.minimum(i + 1, n - 1), j)
    # guarantee i < j
    mask = i2 < j2
    i2, j2 = i2[mask], j2[mask]
    # deduplicate pairs, keep first (lowest) offset per pair
    idx = np.sort(rng.integers(0, n_offsets, i2.shape[0]))
    key = i2 * n + j2
    _, first = np.unique(key, return_index=True)
    return i2[first], j2[first], idx[first]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_host_scores(seed):
    n, n_offsets = 50, 12
    i, j, idx = random_sweep(n, n_offsets, 300, seed)
    want = grow_network_scores(n, i, j, idx, n_offsets, score_idx=0)
    got = sweep_scores_device(n, i, j, idx, n_offsets)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_native_matches_python(seed):
    """The C++ incremental sweep must equal the pure-Python union-find
    scoring exactly."""
    from poppunk_tpu.network.incremental import (IncrementalNetwork,
                                                 sweep_scores_native)

    n, n_offsets = 80, 15
    i, j, idx = random_sweep(n, n_offsets, 600, seed)
    native = sweep_scores_native(n, i, j, idx, n_offsets)
    if native is None:
        pytest.skip("native graph core unavailable")

    order = np.argsort(idx, kind="stable")
    i, j, idx = i[order], j[order], idx[order]
    net = IncrementalNetwork(n)
    want = np.ones(n_offsets)
    pos = 0
    for off in range(n_offsets):
        end = pos
        while end < idx.shape[0] and idx[end] <= off:
            end += 1
        net.add_edges(i[pos:end], j[pos:end])
        pos = end
        want[off] = -net.score(0)
    np.testing.assert_allclose(native, want, atol=1e-12)


def test_empty_edges():
    """Empty networks score 0 (-0.0), matching the host twin
    grow_network_scores — transitivity 0 times anything is 0."""
    got = sweep_scores_device(10, [], [], [], 5)
    assert got.shape == (5,)
    z = np.zeros(0, np.int32)
    want = grow_network_scores(10, z, z, z, 5, score_idx=0)
    np.testing.assert_allclose(got, want)


@pytest.mark.parametrize("score_idx", [0, 1])
def test_never_active_edges_dropped(score_idx):
    """Edges with idx >= n_offsets are 'never active in this sweep': the
    native engine must DROP them (like the Python twin), not clamp them
    into the last offset."""
    from poppunk_tpu.network.incremental import grow_network_scores

    i = np.array([0, 1, 2, 0], dtype=np.int32)
    j = np.array([1, 2, 3, 4], dtype=np.int32)
    idx = np.array([0, 1, 5, 17], dtype=np.int32)  # last two out of range
    n_offsets = 3
    keep = idx < n_offsets
    want = grow_network_scores(6, i[keep], j[keep], idx[keep], n_offsets,
                               score_idx=score_idx, betweenness_sample=100)
    got = grow_network_scores(6, i, j, idx, n_offsets,
                              score_idx=score_idx, betweenness_sample=100)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_duplicate_edges_are_safe():
    # same pair emitted at two offsets must not double-count
    i = np.array([0, 0, 1])
    j = np.array([1, 1, 2])
    idx = np.array([0, 1, 1])
    want = grow_network_scores(4, [0, 1], [1, 2], [0, 1], 3, score_idx=0)
    got = sweep_scores_device(4, i, j, idx, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("score_idx", [1, 2])
@pytest.mark.parametrize("seed", [5, 6])
def test_native_betweenness_scores_match_python(seed, score_idx):
    """The sparse C++ sweep covers the betweenness-weighted scores too;
    with betweenness_sample >= every component size both paths run exact
    all-sources Brandes and must agree to float precision."""
    from poppunk_tpu.network.incremental import (IncrementalNetwork,
                                                 sweep_scores_native)

    n, n_offsets = 60, 8
    i, j, idx = random_sweep(n, n_offsets, 250, seed)
    native = sweep_scores_native(n, i, j, idx, n_offsets,
                                 score_idx=score_idx,
                                 betweenness_sample=10_000)
    if native is None:
        pytest.skip("native graph core unavailable")

    order = np.argsort(idx, kind="stable")
    i, j, idx = i[order], j[order], idx[order]
    net = IncrementalNetwork(n)
    want = np.ones(n_offsets)
    pos = 0
    for off in range(n_offsets):
        end = pos
        while end < idx.shape[0] and idx[end] <= off:
            end += 1
        net.add_edges(i[pos:end], j[pos:end])
        pos = end
        want[off] = -net.score(score_idx, betweenness_sample=10_000)
    np.testing.assert_allclose(native, want, atol=1e-10)


def test_native_sweep_large_sparse():
    """No [n, n] buffers: a 50k-vertex sweep (past the dense regime's
    memory_plan().device_sweep_max_n) completes quickly for every score
    index."""
    from poppunk_tpu.network.incremental import sweep_scores_native

    rng = np.random.default_rng(0)
    n, n_offsets = 50_000, 10
    # clustered edges: 1000 strain-like groups plus random noise
    labels = rng.integers(0, 1000, n)
    a = rng.integers(0, n, 120_000)
    b = rng.integers(0, n, 120_000)
    keep = (labels[a] == labels[b]) | (rng.random(120_000) < 0.02)
    i, j = a[keep], b[keep]
    m = i != j
    i, j = i[m], j[m]
    idx = rng.integers(0, n_offsets, i.shape[0])
    for score_idx in (0, 1, 2):
        scores = sweep_scores_native(n, i.astype(np.int32),
                                     j.astype(np.int32),
                                     idx.astype(np.int32), n_offsets,
                                     score_idx=score_idx,
                                     betweenness_sample=100, seed=1)
        if scores is None:
            pytest.skip("native graph core unavailable")
        assert scores.shape == (n_offsets,)
        assert np.all(np.isfinite(scores))
        # scores are -(t(1-d)...) in [-1, 0]
        assert np.all(scores <= 1e-12) and np.all(scores >= -1.0)
