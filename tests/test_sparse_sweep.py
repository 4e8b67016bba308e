"""Device sparse sweep (ops/sparse_sweep.py + scale.sweep_fill_device).

Every path is pinned to its host oracle:
- sweep_scores_sparse_device == network/incremental.grow_network_scores
  (score_idx 0) over the same (i, j, first-offset) edge list;
- the incremental triangle inclusion-exclusion is stressed with crafted
  batches activating 1, 2 and 3 edges of the same triangle in one step;
- sweep_fill_device produces exactly sweep_first_offsets' edge set;
- refine_fit_device with the device path on == host path off;
- edge_components_device == host connected components.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from poppunk_tpu.network.incremental import grow_network_scores
from poppunk_tpu.ops.sparse_sweep import (SweepEdges,
                                          sweep_scores_sparse_device)
from poppunk_tpu.scale import (edge_components_device,
                               fill_condensed_device, sweep_fill_device,
                               sweep_first_offsets)
from poppunk_tpu.synth import synthetic_population_device

N = 64
KLIST = (13, 17, 21)
SS64 = 4
BBITS = 8


def _no_matmul_sweep(monkeypatch, scale_mod):
    """Route every refine sweep past the dense matmul tier."""
    plan = scale_mod.memory_plan()._replace(matmul_sweep_max_n=0)
    monkeypatch.setattr(scale_mod, "memory_plan", lambda: plan)


@pytest.fixture(scope="module")
def pop():
    return synthetic_population_device(
        N, KLIST, SS64, BBITS, n_strains=3, seed=7, chunk=32,
        core_div=(0.0005, 0.002), strain_div=(0.03, 0.05))


@pytest.fixture(scope="module")
def cd(pop):
    return fill_condensed_device(pop.planes, pop.lengths, pop.freqs,
                                 KLIST, SS64, BBITS, chunk=8, knn=5)


@pytest.fixture(scope="module")
def sc(pop):
    from poppunk_tpu.scale import StreamingCondensed

    return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                              KLIST, SS64, BBITS, chunk=8, knn=5)


def _edges_from_arrays(i, j, d0, n, alloc=None):
    e = len(i)
    alloc = alloc or max(4 * e, 64)
    bi = np.full(alloc, n, np.int32)
    bj = np.full(alloc, n, np.int32)
    bd = np.full(alloc, np.inf, np.float32)
    bi[:e], bj[:e], bd[:e] = i, j, d0
    return SweepEdges(jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(bd),
                      e, n)


def _host_scores(n, i, j, d0, ts):
    idx = np.searchsorted(ts, d0, side="left").astype(np.int32)
    keep = idx < len(ts)
    return grow_network_scores(n, np.asarray(i)[keep], np.asarray(j)[keep],
                               idx[keep], len(ts), 0, 100,
                               rng=np.random.default_rng(1))


class TestKernelVsOracle:
    def test_random_graph(self):
        rng = np.random.default_rng(0)
        n, m = 200, 3000
        pairs = set()
        while len(pairs) < m:
            a, b = rng.integers(0, n, 2)
            if a != b:
                pairs.add((min(a, b), max(a, b)))
        pairs = np.array(sorted(pairs), np.int32)
        d0 = rng.uniform(0, 1, m).astype(np.float32)
        ts = np.linspace(0.05, 1.0, 17)
        edges = _edges_from_arrays(pairs[:, 0], pairs[:, 1], d0, n)
        got, counts = sweep_scores_sparse_device(edges, ts)
        want = _host_scores(n, pairs[:, 0], pairs[:, 1], d0, ts)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(
            counts, np.searchsorted(np.sort(d0), ts, side="right"))

    def test_clique_population(self):
        """Dense-clique structure (the strain regime): heavy triangle
        counts per step."""
        rng = np.random.default_rng(3)
        blocks = [(0, 30), (30, 75), (75, 120)]
        i_l, j_l, d_l = [], [], []
        for lo, hi in blocks:
            for a in range(lo, hi):
                for b in range(a + 1, hi):
                    i_l.append(a)
                    j_l.append(b)
                    d_l.append(rng.uniform(0, 0.4))
        # sparse between-block edges at large d0 (deduped: the kernel's
        # contract is unique pairs, which the fill pass guarantees)
        seen = set()
        while len(seen) < 200:
            a = int(rng.integers(0, 75))
            b = int(rng.integers(75, 120))
            if (a, b) in seen:
                continue
            seen.add((a, b))
            i_l.append(a)
            j_l.append(b)
            d_l.append(rng.uniform(0.4, 1.0))
        i = np.array(i_l, np.int32)
        j = np.array(j_l, np.int32)
        d0 = np.array(d_l, np.float32)
        ts = np.linspace(0.02, 1.0, 23)
        edges = _edges_from_arrays(i, j, d0, 120)
        got, _ = sweep_scores_sparse_device(edges, ts)
        want = _host_scores(120, i, j, d0, ts)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    def test_batched_triangle_births(self):
        """One step activating 1, 2, or 3 edges of the same triangle
        must count it exactly once (the S_all/S_on/S_nn correction)."""
        # triangle A (0,1,2): edges arrive in 3 different steps (k=1)
        # triangle B (3,4,5): two edges in step 2, one in step 1 (k=2)
        # triangle C (6,7,8): all three edges in step 3 (k=3)
        i = np.array([0, 0, 1, 3, 3, 4, 6, 6, 7], np.int32)
        j = np.array([1, 2, 2, 4, 5, 5, 7, 8, 8], np.int32)
        d0 = np.array([0.1, 0.2, 0.3,   # A: steps 1, 2, 3
                       0.1, 0.3, 0.3,   # B: step 1 then two in step 3
                       0.3, 0.3, 0.3],  # C: all in step 3
                      np.float32)
        ts = np.array([0.05, 0.15, 0.25, 0.35])
        edges = _edges_from_arrays(i, j, d0, 9)
        got, counts = sweep_scores_sparse_device(edges, ts)
        want = _host_scores(9, i, j, d0, ts)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        assert counts.tolist() == [0, 2, 3, 9]

    def test_single_threshold_and_empty(self):
        i = np.array([0, 1], np.int32)
        j = np.array([1, 2], np.int32)
        d0 = np.array([0.5, 0.6], np.float32)
        edges = _edges_from_arrays(i, j, d0, 4)
        got, counts = sweep_scores_sparse_device(edges, np.array([0.1]))
        assert counts[0] == 0 and got[0] == 0.0  # empty graph scores -0
        got, counts = sweep_scores_sparse_device(edges, np.array([0.55]))
        want = _host_scores(4, i, j, d0, np.array([0.55]))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestFillDevice:
    @pytest.mark.parametrize("tier", ["buffered", "streaming"])
    def test_fill_matches_fetch(self, cd, sc, tier):
        src = cd if tier == "buffered" else sc
        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        hi, hj, hidx, hd0 = sweep_first_offsets(src, *args)
        edges, cum_fill = sweep_fill_device(src, *args,
                                            n_act=len(offsets),
                                            e_total=len(hi))
        assert edges.count == len(hi)
        k = edges.count
        di, dj = edges.fetch_prefix(k)
        # same edge set (device is d0-sorted; host is position-ordered)
        want = set(zip(hi.tolist(), hj.tolist()))
        got = set(zip(di.tolist(), dj.tolist()))
        assert got == want
        # d0 values match per pair
        d_host = {(a, b): d for a, b, d in zip(hi, hj, hd0)}
        dd = np.asarray(edges.d0[:k] if k == edges.d0.shape[0]
                        else edges.d0[:k])
        for a, b, d in zip(di, dj, np.asarray(dd)):
            np.testing.assert_allclose(d, d_host[(a, b)], rtol=1e-6,
                                       atol=1e-7)

    def test_counts_at_matches_thresholds(self, cd):
        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        hi, hj, hidx, hd0 = sweep_first_offsets(cd, *args)
        edges, cum_fill = sweep_fill_device(cd, *args,
                                            n_act=len(offsets),
                                            e_total=len(hi))
        from poppunk_tpu.scale import _line_d0_params

        _, _, t = _line_d0_params(offsets, 2, 0.1, 0.1, 0.7, 0.7)
        want = [(hd0 <= tv).sum() for tv in t]
        got = edges.counts_at(t)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cum_fill, want)


class TestRefineEquivalence:
    @pytest.mark.parametrize("tier", ["buffered", "streaming"])
    def test_device_path_matches_host_path(self, cd, sc, tier, pop,
                                           monkeypatch):
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import refine_fit_device

        src = cd if tier == "buffered" else sc
        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        # host local policy differs by tier (buffered -> Brent,
        # streaming -> flat micro-grid); the device path always uses the
        # flat micro-grid, so exact-equivalence of the local step is
        # only defined for streaming. The global sweep is pinned for
        # both tiers via no_local.
        kw = dict(max_move=0.05, score_idx=0, seed=4,
                  no_local=(tier == "buffered"))

        # the buffered small-n tier would take the matmul branch; force
        # the sparse one to exercise this code path
        import poppunk_tpu.scale as scale_mod

        _no_matmul_sweep(monkeypatch, scale_mod)

        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
        hx, hy, hs, hsweep = refine_fit_device(src, scale, mean0, mean1,
                                               **kw)
        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "1")
        dx, dy, ds, dsweep = refine_fit_device(src, scale, mean0, mean1,
                                               **kw)
        assert dsweep[0] == "edges" and hsweep[0] == "sparse"
        np.testing.assert_allclose([dx, dy, ds], [hx, hy, hs],
                                   rtol=1e-4, atol=1e-6)

    def test_components_match_host(self, cd):
        from poppunk_tpu.network.graph import Graph
        from poppunk_tpu.network.components import connected_components

        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        hi, hj, hidx, hd0 = sweep_first_offsets(cd, *args)
        edges, cum_fill = sweep_fill_device(cd, *args,
                                            n_act=len(offsets),
                                            e_total=len(hi))
        from poppunk_tpu.scale import _line_d0_params

        _, _, t = _line_d0_params(offsets, 2, 0.1, 0.1, 0.7, 0.7)
        for tv in (t[5], t[12], t[-1]):
            labels, k = edge_components_device(edges, float(tv))
            mask = hd0 <= tv
            G = Graph(cd.n, np.stack([hi[mask], hj[mask]], axis=1))
            want, _ = connected_components(G)
            assert k == int(mask.sum())
            np.testing.assert_array_equal(labels, want)


class TestAdaptiveCap:
    def test_device_budget_overrides_host_cap(self, cd, pop, monkeypatch):
        """max_sweep_fetch below even the first offset's pair count:
        the host path refuses, the device path budgets its own cap from
        free HBM and completes (the 81920-genome tier's first offset
        holds 47M pairs against the 40M host cap)."""
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import refine_fit_device
        import poppunk_tpu.scale as scale_mod

        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        kw = dict(max_move=0.05, score_idx=0, seed=4, no_local=True,
                  max_sweep_fetch=1)

        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
        with pytest.raises(RuntimeError, match="first sweep offset"):
            refine_fit_device(cd, scale, mean0, mean1, **kw)

        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "1")
        x, y, s, sweep = refine_fit_device(cd, scale, mean0, mean1, **kw)
        assert sweep[0] == "edges"
        # and the result equals an uncapped host run
        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
        kw["max_sweep_fetch"] = cd.n_pairs
        hx, hy, hs, _ = refine_fit_device(cd, scale, mean0, mean1, **kw)
        np.testing.assert_allclose([x, y, s], [hx, hy, hs],
                                   rtol=1e-4, atol=1e-6)

    def test_estimated_counts_match_exact(self, cd, sc, pop, monkeypatch):
        """The device path with a subsample estimate must find the same
        boundary as with the exact counts pre-pass (scores never depend
        on the estimate; only buffer sizing and worst-scored offsets
        do)."""
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import refine_fit_device
        import poppunk_tpu.scale as scale_mod

        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        kw = dict(max_move=0.05, score_idx=0, seed=4)
        # uniform pair subsample (>= the estimator's minimum size)
        rng = np.random.default_rng(0)
        sub = Xs[rng.integers(0, len(Xs), 20000)] * scale

        for src in (cd, sc):
            exact = refine_fit_device(src, scale, mean0, mean1, **kw)
            est = refine_fit_device(src, scale, mean0, mean1,
                                    est_pairs=sub, **kw)
            np.testing.assert_allclose(est[:3], exact[:3],
                                       rtol=1e-5, atol=1e-7)

    def test_fill_overflow_falls_back_to_exact_counts(self, cd, sc, pop,
                                                      monkeypatch):
        """A SweepFillOverflow (the subsample estimate under-sized the
        buffer) must trigger the exact counts pass and a resized refill
        — not abort the pipeline (ADVICE r4)."""
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import refine_fit_device, SweepFillOverflow
        import poppunk_tpu.scale as scale_mod

        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        kw = dict(max_move=0.05, score_idx=0, seed=4)
        rng = np.random.default_rng(0)
        sub = Xs[rng.integers(0, len(Xs), 20000)] * scale

        real_fill = scale_mod.sweep_fill_device
        calls = {"n": 0}

        def exploding_fill(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise SweepFillOverflow(
                    "sweep fill overflow: forced by test")
            return real_fill(*args, **kwargs)

        for src in (cd, sc):
            calls["n"] = 0
            exact = refine_fit_device(src, scale, mean0, mean1, **kw)
            monkeypatch.setattr(scale_mod, "sweep_fill_device",
                                exploding_fill)
            timings = {}
            est = refine_fit_device(src, scale, mean0, mean1,
                                    est_pairs=sub, timings_out=timings,
                                    **kw)
            monkeypatch.setattr(scale_mod, "sweep_fill_device", real_fill)
            assert calls["n"] >= 2        # overflow, then the resized fill
            assert "counts" in timings    # the exact pass actually ran
            np.testing.assert_allclose(est[:3], exact[:3],
                                       rtol=1e-5, atol=1e-7)


class TestMeshShardedSweep:
    """The device sparse sweep on mesh-sharded populations (row- and
    column-sharded) == the single-device / host paths: per-device fill
    shards all-gathered over the mesh must hold exactly the in-boundary
    pair set, return exact per-offset counts, and drive refine to the
    same boundary (VERDICT r4 item 1)."""

    ARGS = (2, 0.1, 0.1, 0.7, 0.7)

    @pytest.fixture(scope="class")
    def msc(self, pop):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        mesh = get_mesh(len(jax.devices()))
        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=4, knn=5,
                                  mesh=mesh)

    @pytest.fixture(scope="class")
    def csc(self, pop):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        mesh = get_mesh(len(jax.devices()))
        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=4, knn=5,
                                  mesh=mesh, shard_planes=True)

    @pytest.mark.parametrize("tier", ["row", "col"])
    def test_mesh_fill_matches_fetch(self, msc, csc, sc, tier):
        from poppunk_tpu.scale import (sweep_counts_mesh,
                                       sweep_fill_device)

        src = msc if tier == "row" else csc
        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx, hd0 = sweep_first_offsets(sc, scale, offsets,
                                                *self.ARGS)
        cum_global, per_dev = sweep_counts_mesh(src, scale, offsets,
                                                *self.ARGS)
        assert per_dev.sum(axis=0)[-1] == cum_global[-1]
        edges, cum_fill = sweep_fill_device(
            src, scale, offsets, *self.ARGS, n_act=len(offsets),
            e_total=int(cum_global[-1]),
            e_per_dev=per_dev[:, -1])
        assert edges.count == len(hi)
        np.testing.assert_array_equal(cum_fill, cum_global)
        fi, fj = edges.fetch_prefix(edges.count)
        assert (sorted(zip(fi.tolist(), fj.tolist()))
                == sorted(zip(hi.tolist(), hj.tolist())))
        # the d0-sorted prefix at interior thresholds matches the host
        # pair sets too
        from poppunk_tpu.scale import _line_d0_params

        _, _, t = _line_d0_params(offsets, *self.ARGS)
        for o in (4, 11):
            k = int(edges.counts_at(np.array([t[o]]))[0])
            pi, pj = edges.fetch_prefix(k)
            mask = hidx <= o
            assert (sorted(zip(pi.tolist(), pj.tolist()))
                    == sorted(zip(hi[mask].tolist(),
                                  hj[mask].tolist())))

    @pytest.mark.parametrize("tier", ["row", "col"])
    def test_mesh_estimate_sizing_and_overflow(self, msc, csc, sc, tier,
                                               monkeypatch):
        """Estimate-based shard sizing fills completely when generous;
        a deliberately under-sized shard raises SweepFillOverflow."""
        from poppunk_tpu.scale import (SweepFillOverflow,
                                       sweep_counts_mesh,
                                       sweep_fill_device)

        src = msc if tier == "row" else csc
        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        cum_global, per_dev = sweep_counts_mesh(src, scale, offsets,
                                                *self.ARGS)
        total = int(cum_global[-1])
        edges, _ = sweep_fill_device(src, scale, offsets, *self.ARGS,
                                     n_act=len(offsets), e_total=total)
        assert edges.count == total
        # force a tiny per-shard bucket so the slack floor cannot hide
        # the overflow at this tiny n (the mesh fill resolves _bucket
        # from the module at call time)
        import poppunk_tpu.ops.sparse_sweep as ss

        monkeypatch.setattr(ss, "_bucket", lambda k, lo=0: 8)
        with pytest.raises(SweepFillOverflow):
            sweep_fill_device(src, scale, offsets, *self.ARGS,
                              n_act=len(offsets), e_total=total,
                              e_per_dev=np.full(src._n_dev, 1))

    @pytest.mark.parametrize("tier", ["row", "col"])
    def test_mesh_refine_matches_host(self, msc, csc, pop, tier,
                                      monkeypatch):
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import refine_fit_device
        import poppunk_tpu.scale as scale_mod

        src = msc if tier == "row" else csc
        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        kw = dict(max_move=0.05, score_idx=0, seed=4)

        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "0")
        hx, hy, hs, hsweep = refine_fit_device(src, scale, mean0, mean1,
                                               **kw)
        monkeypatch.setenv("POPPUNK_TPU_SPARSE_SWEEP", "1")
        dx, dy, ds, dsweep = refine_fit_device(src, scale, mean0, mean1,
                                               **kw)
        assert dsweep[0] == "edges" and hsweep[0] == "sparse"
        np.testing.assert_allclose([dx, dy, ds], [hx, hy, hs],
                                   rtol=1e-4, atol=1e-6)

    def test_mesh_components_match_host(self, msc, sc):
        from poppunk_tpu.network.graph import Graph
        from poppunk_tpu.network.components import connected_components
        from poppunk_tpu.scale import (_line_d0_params,
                                       sweep_fill_device)

        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx, hd0 = sweep_first_offsets(sc, scale, offsets,
                                                *self.ARGS)
        edges, _ = sweep_fill_device(msc, scale, offsets, *self.ARGS,
                                     n_act=len(offsets),
                                     e_total=len(hi))
        _, _, t = _line_d0_params(offsets, *self.ARGS)
        for tv in (t[5], t[12], t[-1]):
            labels, k = edge_components_device(edges, float(tv))
            mask = hd0 <= tv
            G = Graph(msc.n, np.stack([hi[mask], hj[mask]], axis=1))
            want, _ = connected_components(G)
            assert k == int(mask.sum())
            np.testing.assert_array_equal(labels, want)


class TestBootstrap:
    """The two-round bootstrap: model fit on directly-computed subsample
    distances, then ONE streaming pass fusing dists + kNN + maxima with
    the refine boundary-band edge fill (scale._stream_stats_fill_range /
    StreamingCondensed.run_pass1). Pinned to the separate-pass path."""

    ARGS = (2, 0.1, 0.1, 0.7, 0.7)

    def _spec(self, scale, offsets, e_total, n_act=None):
        return dict(scale=np.asarray(scale, np.float64),
                    offsets=np.asarray(offsets), slope=self.ARGS[0],
                    line=self.ARGS[1:], n_act=n_act or len(offsets),
                    e_total=int(e_total))

    def test_fused_pass_matches_separate(self, pop, sc):
        from poppunk_tpu.scale import (StreamingCondensed, _line_d0_params,
                                       sweep_fill_device)

        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx, hd0 = sweep_first_offsets(sc, scale, offsets,
                                                *self.ARGS)
        want_edges, want_cum = sweep_fill_device(
            sc, scale, offsets, *self.ARGS, n_act=len(offsets),
            e_total=len(hi))

        boot = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5,
                                  defer=True)
        # stats fields don't exist until pass 1 runs
        assert not hasattr(boot, "knn_col")
        boot.run_pass1(self._spec(scale, offsets, len(hi)))
        # stats: identical to the non-deferred pass
        np.testing.assert_array_equal(boot.knn_col, sc.knn_col)
        np.testing.assert_array_equal(boot.knn_dist, sc.knn_dist)
        np.testing.assert_array_equal(boot.max_scale(), sc.max_scale())
        # fill: same edge set, d0 values, and exact full-grid counts
        pf = boot.pop_prefill()
        assert pf is not None and boot.pop_prefill() is None
        edges, cum, spec = pf
        assert edges.count == want_edges.count == len(hi)
        np.testing.assert_array_equal(cum, want_cum)
        fi, fj = edges.fetch_prefix(edges.count)
        assert (sorted(zip(fi.tolist(), fj.tolist()))
                == sorted(zip(hi.tolist(), hj.tolist())))
        _, _, t = _line_d0_params(offsets, *self.ARGS)
        np.testing.assert_array_equal(edges.counts_at(t),
                                      [(hd0 <= tv).sum() for tv in t])

    def test_band_narrower_than_grid(self, pop, sc):
        """n_act < n_grid stores only band pairs but counts the FULL
        grid exactly."""
        from poppunk_tpu.scale import (StreamingCondensed,
                                       sweep_fill_device)

        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx, hd0 = sweep_first_offsets(sc, scale, offsets,
                                                *self.ARGS)
        n_act = 7
        in_band = int((hidx < n_act).sum())
        _, want_cum = sweep_fill_device(
            sc, scale, offsets, *self.ARGS, n_act=len(offsets),
            e_total=len(hi))
        boot = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5,
                                  defer=True)
        boot.run_pass1(self._spec(scale, offsets, in_band, n_act=n_act))
        edges, cum, spec = boot.pop_prefill()
        assert edges.count == in_band
        np.testing.assert_array_equal(cum, want_cum)  # full grid, exact
        fi, fj = edges.fetch_prefix(edges.count)
        mask = hidx < n_act
        assert (sorted(zip(fi.tolist(), fj.tolist()))
                == sorted(zip(hi[mask].tolist(), hj[mask].tolist())))

    def test_overflow_keeps_stats_discards_prefill(self, pop, sc,
                                                   monkeypatch):
        from poppunk_tpu.scale import StreamingCondensed
        import poppunk_tpu.ops.sparse_sweep as ss

        scale = sc.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        boot = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5,
                                  defer=True)
        monkeypatch.setattr(ss, "_bucket", lambda k, lo=0: 8)
        boot.run_pass1(self._spec(scale, offsets, 8))
        assert boot.pop_prefill() is None  # truncated fill discarded
        np.testing.assert_array_equal(boot.knn_col, sc.knn_col)
        np.testing.assert_array_equal(boot.max_scale(), sc.max_scale())

    def test_refine_with_prefill_matches_standard(self, pop, sc,
                                                  monkeypatch):
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import (StreamingCondensed, plan_sweep_band,
                                       refine_fit_device)
        import poppunk_tpu.scale as scale_mod

        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        kw = dict(max_move=0.05, score_idx=0, seed=4)
        rng = np.random.default_rng(0)
        sub = Xs[rng.integers(0, len(Xs), 20000)] * scale

        spec = plan_sweep_band(sc, scale, mean0, mean1,
                               max_move=kw["max_move"], est_pairs=sub)
        assert spec is not None
        boot = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5,
                                  defer=True)
        boot.run_pass1(spec)
        want = refine_fit_device(sc, scale, mean0, mean1, **kw)
        timings = {}
        got = refine_fit_device(boot, scale, mean0, mean1,
                                timings_out=timings,
                                prefill=boot.pop_prefill(), **kw)
        assert got[3][0] == "edges"
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5,
                                   atol=1e-7)
        # no fill or counts pass ran in the prefilled refine
        assert timings.get("counts", 0.0) == 0.0
        assert timings.get("fill", 0.0) < 0.5

    def test_pipeline_bootstrap_equals_standard(self, monkeypatch):
        from poppunk_tpu.scale import run_scale_pipeline
        import poppunk_tpu.parallel.mesh as mesh_mod

        # force the single-device streaming tier (the conftest exposes 8
        # virtual devices, which would shard and disable the bootstrap)
        monkeypatch.setattr(mesh_mod, "get_mesh", lambda *a, **k: None)
        kw = dict(n=256, streaming=True, chunk=32, use_pallas=False,
                  log=lambda m: None)
        monkeypatch.setenv("POPPUNK_TPU_BOOTSTRAP", "0")
        std = run_scale_pipeline(**kw)
        monkeypatch.setenv("POPPUNK_TPU_BOOTSTRAP", "1")
        boot = run_scale_pipeline(**kw)
        assert boot["ari"] == std["ari"] == 1.0
        assert boot["n_clusters"] == std["n_clusters"]
        assert boot["n_edges"] == std["n_edges"]
        # the bootstrap pipeline must not have paid a separate fill
        assert boot["refine_phase_s"].get("fill", 0.0) < 0.5
        assert boot["refine_phase_s"].get("counts", 0.0) == 0.0

    def test_prefill_spec_mismatch_ignored(self, pop, sc, monkeypatch):
        """A prefill whose geometry differs from the refine call (e.g.
        replanned max_move) must be silently ignored, not misused."""
        from poppunk_tpu.ops.distances import condensed_self_block
        from poppunk_tpu.scale import (StreamingCondensed, plan_sweep_band,
                                       refine_fit_device)
        import poppunk_tpu.scale as scale_mod

        host = condensed_self_block(
            np.asarray(pop.planes_gm), np.asarray(pop.lengths),
            np.asarray(pop.freqs), KLIST, SS64, BBITS)
        scale = host.max(axis=0)
        Xs = host / scale
        mean0 = Xs[Xs[:, 0] < 0.3].mean(axis=0)
        mean1 = Xs[Xs[:, 0] >= 0.3].mean(axis=0)
        _no_matmul_sweep(monkeypatch, scale_mod)
        rng = np.random.default_rng(0)
        sub = Xs[rng.integers(0, len(Xs), 20000)] * scale

        spec = plan_sweep_band(sc, scale, mean0, mean1, max_move=0.1,
                               est_pairs=sub)
        boot = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5,
                                  defer=True)
        boot.run_pass1(spec)
        kw = dict(max_move=0.05, score_idx=0, seed=4)  # != planned 0.1
        want = refine_fit_device(sc, scale, mean0, mean1,
                                 est_pairs=sub, **kw)
        timings = {}
        got = refine_fit_device(boot, scale, mean0, mean1,
                                est_pairs=sub, timings_out=timings,
                                prefill=boot.pop_prefill(), **kw)
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5,
                                   atol=1e-7)
        # the mismatched prefill must NOT have been consumed: a real
        # fill ran instead
        assert timings.get("fill", 0.0) > 0.0
