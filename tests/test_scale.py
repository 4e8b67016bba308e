"""Device-resident scale pipeline (poppunk_tpu/scale.py, synth.py).

Small-n equality against the host streaming path — the semantics the 20k+
device run (bench.py --scale) relies on. Every consumer of the folded device
buffer is checked against its host oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from poppunk_tpu.ops.boundary import threshold_iterate_1d_fast
from poppunk_tpu.ops.distances import condensed_self_block
from poppunk_tpu.ops.sparse_knn import knn_from_condensed
from poppunk_tpu.scale import (
    CondensedDevice, build_d0_square, components_device,
    fill_condensed_device, fold_index, fold_inverse, matmul_sweep_scores,
    run_scale_pipeline, sweep_first_offsets)
from poppunk_tpu.synth import synthetic_population_device

N = 64
KLIST = (13, 17, 21)
SS64 = 4
BBITS = 8


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
def host_condensed(pop):
    return condensed_self_block(
        np.asarray(pop.planes_gm), np.asarray(pop.lengths),
        np.asarray(pop.freqs), KLIST, SS64, BBITS)


class TestFoldIndex:
    def test_roundtrip_all_pairs(self):
        n = 20
        i, j = np.triu_indices(n, 1)
        pos = fold_index(i, j, n)
        # bijective onto [0, n_pairs)
        assert sorted(pos) == list(range(n * (n - 1) // 2))
        i2, j2 = fold_inverse(pos, n)
        assert np.array_equal(i, i2) and np.array_equal(j, j2)


class TestFilledBuffer:
    def test_matches_host_condensed(self, cd, host_condensed):
        """Folded device buffer == streaming host path, exactly."""
        i, j = np.triu_indices(N, 1)
        flat = np.asarray(cd.buf).reshape(-1, 2)
        dev = flat[fold_index(i, j, N)]
        # host condensed rows are in i<j order already
        assert np.array_equal(dev, host_condensed)

    def test_fused_knn_matches_host(self, cd, host_condensed):
        rows, cols, dists = cd.knn_sparse()
        h_rows, h_cols, h_dists = knn_from_condensed(
            host_condensed[:, 0], N, 5)
        assert np.array_equal(rows, h_rows)
        # device kNN reads d(j, i) from row j's block; the host reads the
        # condensed d(i, j) from row i — identical maths except the
        # reverse-complement dot whose 4-term sum runs in opposite order,
        # so values may differ in the last ulp and epsilon-ties may swap
        np.testing.assert_allclose(dists, h_dists, rtol=1e-5, atol=1e-7)
        assert (cols == h_cols).mean() > 0.9

    def test_subsample_values(self, cd, host_condensed):
        sub = cd.subsample_pairs(200, seed=3)
        assert sub.shape == (200, 2)
        # every subsampled row exists in the condensed matrix
        allrows = {tuple(r) for r in host_condensed.tolist()}
        assert all(tuple(r) in allrows for r in sub.tolist())

    def test_max_scale(self, cd, host_condensed):
        np.testing.assert_allclose(cd.max_scale(),
                                   host_condensed.max(axis=0), rtol=1e-6)


class TestDeviceSweep:
    def test_matches_host_fast_sweep(self, cd, host_condensed):
        scale = host_condensed.max(axis=0)
        Xs = host_condensed / scale
        mean0 = np.array([0.1, 0.1])
        mean1 = np.array([0.7, 0.7])
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx = threshold_iterate_1d_fast(
            Xs, offsets, 2, mean0[0], mean0[1], mean1[0], mean1[1])
        di, dj, didx, dd0 = sweep_first_offsets(
            cd, scale, offsets, 2, mean0[0], mean0[1], mean1[0], mean1[1])
        host = sorted(zip(hi, hj, hidx))
        dev = sorted(zip(di, dj, didx))
        assert host == dev
        assert len(dd0) == len(di)

    @pytest.mark.parametrize("chunk_rows", [8, 7, 64])
    def test_counts_buffered_matches_host(self, cd, host_condensed,
                                          chunk_rows):
        """chunk_rows=8 divides half (pure scan), 7 leaves a ragged tail
        chunk, 64 > half clamps to one full chunk."""
        from poppunk_tpu.scale import sweep_counts_buffered

        scale = host_condensed.max(axis=0)
        Xs = host_condensed / scale
        mean0, mean1 = np.array([0.1, 0.1]), np.array([0.7, 0.7])
        offsets = np.linspace(0.0, 0.5, 20)
        _, _, hidx = threshold_iterate_1d_fast(
            Xs, offsets, 2, mean0[0], mean0[1], mean1[0], mean1[1])
        want = np.cumsum(np.bincount(hidx, minlength=len(offsets)))
        got = sweep_counts_buffered(cd, scale, offsets, 2, mean0[0],
                                    mean0[1], mean1[0], mean1[1],
                                    chunk_rows=chunk_rows)
        assert np.array_equal(got, want)

    def test_buffered_fetch_honours_n_act(self, cd, host_condensed):
        scale = host_condensed.max(axis=0)
        Xs = host_condensed / scale
        mean0, mean1 = np.array([0.1, 0.1]), np.array([0.7, 0.7])
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx = threshold_iterate_1d_fast(
            Xs, offsets[:7], 2, mean0[0], mean0[1], mean1[0], mean1[1])
        di, dj, didx, _ = sweep_first_offsets(
            cd, scale, offsets, 2, mean0[0], mean0[1], mean1[0], mean1[1],
            _n_act=7)
        assert sorted(zip(hi, hj, hidx)) == sorted(zip(di, dj, didx))

    @pytest.mark.parametrize("score_idx", [1, 0])
    def test_refine_cap_matches_uncapped(self, cd, host_condensed,
                                         score_idx):
        """The buffered sparse branch with a binding max_sweep_fetch must
        find the same boundary as the uncapped fetch (dense offsets past
        the cap score worst and never hold the optimum)."""
        from poppunk_tpu.scale import refine_fit_device

        scale = host_condensed.max(axis=0)
        Xs = host_condensed / scale
        within = Xs[Xs[:, 0] < 0.3]
        between = Xs[Xs[:, 0] >= 0.3]
        mean0 = within.mean(axis=0)
        mean1 = between.mean(axis=0)
        kw = dict(score_idx=score_idx, betweenness_sample=1000, seed=1,
                  no_local=True, max_move=0.05)
        if score_idx == 0:  # force the sparse HOST branch (the device
            # sparse sweep budgets its own cap and ignores
            # max_sweep_fetch, which only governs host fetches)
            import os as _os

            import poppunk_tpu.scale as sc_mod
            orig = sc_mod.memory_plan
            plan = orig()._replace(matmul_sweep_max_n=0)
            sc_mod.memory_plan = lambda: plan
            _os.environ["POPPUNK_TPU_SPARSE_SWEEP"] = "0"
            try:
                full = refine_fit_device(cd, scale, mean0, mean1, **kw)
                capped = refine_fit_device(cd, scale, mean0, mean1,
                                           max_sweep_fetch=cd.n_pairs // 3,
                                           **kw)
            finally:
                sc_mod.memory_plan = orig
                del _os.environ["POPPUNK_TPU_SPARSE_SWEEP"]
        else:
            full = refine_fit_device(cd, scale, mean0, mean1, **kw)
            capped = refine_fit_device(cd, scale, mean0, mean1,
                                       max_sweep_fetch=cd.n_pairs // 3,
                                       **kw)
        assert capped[0] == pytest.approx(full[0])
        assert capped[1] == pytest.approx(full[1])
        # the capped fetch really fetched fewer pairs
        assert len(capped[3][1]) < len(full[3][1])


class TestMatmulSweep:
    """The all-on-device scorer vs the host sparse scorer, exactly."""

    LINE = (0.1, 0.1, 0.7, 0.7)

    def test_scores_match_host_scorer(self, cd, host_condensed):
        from poppunk_tpu.network.incremental import grow_network_scores

        scale = host_condensed.max(axis=0)
        offsets = np.linspace(0.0, 0.5, 12)
        d0_sq, t = build_d0_square(cd, scale, 2, *self.LINE, offsets)
        scores, edges = matmul_sweep_scores(d0_sq, t)

        hi, hj, hidx, _ = sweep_first_offsets(cd, scale, offsets, 2,
                                              *self.LINE)
        host_scores = grow_network_scores(N, hi, hj, hidx, len(offsets), 0,
                                          100, rng=np.random.default_rng(1))
        np.testing.assert_allclose(scores, host_scores, rtol=1e-5,
                                   atol=1e-7)
        for o in range(len(offsets)):
            assert edges[o] == (hidx <= o).sum()

    def test_components_match_host(self, cd, host_condensed):
        from poppunk_tpu.network.components import connected_components
        from poppunk_tpu.network.graph import Graph

        scale = host_condensed.max(axis=0)
        offsets = np.linspace(0.0, 0.5, 12)
        d0_sq, t = build_d0_square(cd, scale, 2, *self.LINE, offsets)
        hi, hj, hidx, _ = sweep_first_offsets(cd, scale, offsets, 2,
                                              *self.LINE)
        for o in (3, 7, 11):
            labels, n_edges = components_device(d0_sq, t[o])
            mask = hidx <= o
            assert n_edges == mask.sum()
            host_labels = connected_components(
                Graph(N, np.stack([hi[mask], hj[mask]], axis=1)))[0]
            # identical partitions (label names may differ)
            for lab in (labels, host_labels):
                assert lab.shape == (N,)
            pairs = {(a, b) for a, b in zip(labels, host_labels)}
            assert len(pairs) == len(set(labels)) == len(set(host_labels))


class TestEndToEnd:
    def test_mini_pipeline_recovers_strains(self, tmp_path):
        # >=10 strains: with few strains the correct boundary's network is
        # dense (density ~ 1/n_strains), which PopPUNK's transitivity *
        # (1 - density) score genuinely penalises — a property of the
        # reference score, not this pipeline (host refine picks the same
        # boundary; see test_matches_host_fast_sweep)
        out = run_scale_pipeline(
            n=256, klist=(13, 15, 17, 19, 21, 23), sketchsize64=64,
            bbits=8, n_strains=10, chunk=32, knn=3, subsample=5000, seed=5,
            synth_kwargs=dict(core_div=(0.0005, 0.002),
                              strain_div=(0.04, 0.06),
                              accessory_within=(0.93, 0.97),
                              accessory_strain=(0.70, 0.80)),
            log=lambda m: None)
        assert out["n"] == 256
        assert out["pairs_per_s"] > 0
        # well-separated synthetic strains must come back as the clusters
        assert out["ari"] > 0.99
        assert out["n_clusters"] == 10
        # the fused-kNN lineage tier runs (its clustering is NOT
        # asserted against strains: at this toy sketch size ~6% of
        # genomes have 0-distance cross-strain neighbours, so rank-k
        # graphs bridge — exactly as the reference's lineage mode
        # would on the same distances)
        assert 1 <= out["n_lineages"] <= out["n"]
        assert 0.0 <= out["ari_lineage"] <= 1.0


class TestStreamingCondensed:
    """StreamingCondensed (no O(n^2) storage) == the buffered fill."""

    @pytest.fixture(scope="class")
    def sc(self, pop):
        from poppunk_tpu.scale import StreamingCondensed

        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=5)

    def test_knn_matches_buffered(self, sc, cd):
        assert np.array_equal(sc.knn_col, cd.knn_col)
        assert np.array_equal(sc.knn_dist, cd.knn_dist)

    def test_max_scale_matches(self, sc, cd):
        np.testing.assert_allclose(sc.max_scale(), cd.max_scale(),
                                   rtol=1e-6)

    def test_subsample_matches_buffered(self, sc, cd):
        # same positions drawn (same rng stream); values recomputed
        # per-pair instead of gathered — ulp-level reassociation in the
        # correction is amplified by the k-mer curve fit, so tolerance
        # is looser than elsewhere
        s_sub = sc.subsample_pairs(200, seed=3, block=64)
        b_sub = cd.subsample_pairs(200, seed=3)
        np.testing.assert_allclose(s_sub, b_sub, rtol=5e-4, atol=1e-5)

    def test_predeclared_subsample_is_buffered_exact(self, pop, cd):
        # subsample declared at construction is gathered from the SAME
        # _fold_block outputs the buffered fill stores: bit-identical
        from poppunk_tpu.scale import StreamingCondensed

        sc2 = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                 KLIST, SS64, BBITS, chunk=8, knn=5,
                                 subsample=(200, 3))
        assert np.array_equal(sc2.subsample_pairs(200, seed=3),
                              cd.subsample_pairs(200, seed=3))

    def test_sweep_matches_buffered(self, sc, cd):
        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        bi, bj, bidx, bd0 = sweep_first_offsets(cd, *args)
        si, sj, sidx, sd0 = sweep_first_offsets(sc, *args)
        assert np.array_equal(si, bi)
        assert np.array_equal(sj, bj)
        assert np.array_equal(sidx, bidx)
        np.testing.assert_allclose(sd0, bd0, rtol=1e-6, atol=1e-7)

    def test_large_k_topk_path_matches_host(self, pop, host_condensed):
        # knn > 16 switches _fold_block to lax.top_k (the embedding
        # pass's k=50 regime); ties and order must still match the host
        # oracle, here on the ACCESSORY column
        from poppunk_tpu.scale import StreamingCondensed

        sck = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                 KLIST, SS64, BBITS, chunk=8, knn=20,
                                 dist_col=1)
        h_rows, h_cols, h_dists = knn_from_condensed(
            host_condensed[:, 1], N, 20)
        rows, cols, dists = sck.knn_sparse()
        assert np.array_equal(rows, h_rows)
        assert np.array_equal(cols, h_cols)
        # accessory values carry more f32 reassociation noise than core
        np.testing.assert_allclose(dists, h_dists, rtol=3e-4, atol=1e-5)

    @pytest.mark.parametrize("slope", [0, 1])
    def test_indiv_slope_sweep_matches_host(self, sc, host_condensed,
                                            slope):
        # slope 0/1 sweeps back the --indiv-refine core-only /
        # accessory-only refits (cli/scale.py); oracle = host fast sweep
        scale = host_condensed.max(axis=0)
        Xs = host_condensed / scale
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx = threshold_iterate_1d_fast(
            Xs, offsets, slope, 0.1, 0.1, 0.7, 0.7)
        si, sj, sidx, _ = sweep_first_offsets(sc, scale, offsets, slope,
                                              0.1, 0.1, 0.7, 0.7)
        assert sorted(zip(hi, hj, hidx)) == sorted(zip(si, sj, sidx))

    def test_pipeline_streaming_equals_buffered(self):
        kwargs = dict(
            n=256, klist=(13, 15, 17, 19, 21, 23), sketchsize64=64,
            bbits=8, n_strains=10, chunk=32, knn=3, subsample=5000, seed=5,
            synth_kwargs=dict(core_div=(0.0005, 0.002),
                              strain_div=(0.04, 0.06),
                              accessory_within=(0.93, 0.97),
                              accessory_strain=(0.70, 0.80)))
        s_log, b_log, c_log = [], [], []
        s_out = run_scale_pipeline(streaming=True, log=s_log.append,
                                   **kwargs)
        b_out = run_scale_pipeline(streaming=False, sharded=False,
                                   log=b_log.append, **kwargs)
        # no buffer => refine routes to the device sparse sweep (the
        # CPU test env runs an 8-device mesh, so this exercises the
        # mesh-sharded fill); the buffered run (n at most
        # memory_plan().matmul_sweep_max_n) takes the matmul sweep
        assert any("via edges sweep" in m for m in s_log)
        assert any("via device sweep" in m for m in b_log)
        assert s_out["ari"] == b_out["ari"] == 1.0
        assert s_out["n_clusters"] == b_out["n_clusters"] == 10
        assert s_out["n_edges"] == b_out["n_edges"]

        # a tight fetch cap prunes the dense tail offsets (histogram
        # pre-pass) without changing the chosen boundary or clusters
        c_out = run_scale_pipeline(streaming=True, max_sweep_fetch=8000,
                                   log=c_log.append, **kwargs)
        assert c_out["ari"] == 1.0
        assert c_out["n_clusters"] == 10
        assert c_out["n_edges"] == s_out["n_edges"]


class TestOddNStreaming:
    """Odd populations: one exactly-masked pad genome (pack_to_even).

    Every consumer must behave as if the pad never existed, checked
    against the host streaming oracle on the REAL n=63 genomes."""

    N_ODD = 63

    @pytest.fixture(scope="class")
    def odd(self, pop):
        import jax.numpy as jnpp

        from poppunk_tpu.scale import StreamingCondensed

        # take 63 of the 64 synthetic genomes, pad back to 64 with zeros
        planes = np.asarray(pop.planes)[:, :, :self.N_ODD, :]
        planes_pad = np.zeros(
            planes.shape[:2] + (self.N_ODD + 1,) + planes.shape[3:],
            np.uint32)
        planes_pad[:, :, :self.N_ODD] = planes
        lengths = np.concatenate([np.asarray(pop.lengths)[:self.N_ODD],
                                  [2_000_000]]).astype(np.int32)
        freqs = np.concatenate([np.asarray(pop.freqs)[:self.N_ODD],
                                [[0.25] * 4]]).astype(np.float32)
        sc = StreamingCondensed(jnpp.asarray(planes_pad), lengths, freqs,
                                KLIST, SS64, BBITS, chunk=8, knn=5,
                                subsample=(150, 3), n_real=self.N_ODD)
        host = condensed_self_block(
            np.moveaxis(planes, 2, 0), lengths[:self.N_ODD],
            freqs[:self.N_ODD], KLIST, SS64, BBITS)
        return sc, host

    def test_shape_bookkeeping(self, odd):
        sc, host = odd
        assert sc.n == self.N_ODD
        assert sc.n_pairs == self.N_ODD * (self.N_ODD - 1) // 2
        assert len(host) == sc.n_pairs

    def test_knn_matches_host(self, odd):
        sc, host = odd
        h_rows, h_cols, h_dists = knn_from_condensed(
            host[:, 0], self.N_ODD, 5)
        rows, cols, dists = sc.knn_sparse()
        assert np.array_equal(rows, h_rows)
        np.testing.assert_allclose(dists, h_dists, rtol=1e-5, atol=1e-7)
        assert (cols < self.N_ODD).all()  # pads never neighbours

    def test_max_scale_excludes_pad(self, odd):
        sc, host = odd
        # pad pairs are (1.0, 1.0); real maxima here are far below 1
        np.testing.assert_allclose(sc.max_scale(), host.max(axis=0),
                                   rtol=1e-6)
        assert (sc.max_scale() < 1.0).all()

    def test_subsample_real_pairs(self, odd):
        sc, host = odd
        sub = sc.subsample_pairs(150, seed=3)
        assert sub.shape == (150, 2)
        allrows = {tuple(np.round(r, 5)) for r in host.tolist()}
        hits = sum(tuple(np.round(r, 5)) in allrows for r in sub.tolist())
        assert hits >= 145  # ulp rounding may move a few off-grid

    def test_sweep_matches_host(self, odd):
        sc, host = odd
        scale = host.max(axis=0)
        Xs = host / scale
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx = threshold_iterate_1d_fast(
            Xs, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        si, sj, sidx, _ = sweep_first_offsets(sc, scale, offsets, 2,
                                              0.1, 0.1, 0.7, 0.7)
        assert sorted(zip(hi, hj, hidx)) == sorted(zip(si, sj, sidx))
        assert (si < self.N_ODD).all() and (sj < self.N_ODD).all()


class TestStreaming2DSweep:
    """The unconstrained (2-D grid) streaming sweep vs host oracles."""

    X_GRID = np.linspace(0.05, 0.6, 7).astype(np.float32)
    Y_GRID = np.linspace(0.08, 0.7, 6).astype(np.float32)

    @pytest.fixture(scope="class")
    def sc(self, pop):
        from poppunk_tpu.scale import StreamingCondensed

        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=8, knn=1)

    def test_counts_match_host(self, sc, host_condensed):
        from poppunk_tpu.ops.boundary import line_dist
        from poppunk_tpu.scale import sweep2d_counts_streaming

        scale = host_condensed.max(axis=0)
        Xs = (host_condensed / scale).astype(np.float32)
        cum = sweep2d_counts_streaming(sc, scale, self.X_GRID, self.Y_GRID)
        for r, ym in enumerate(self.Y_GRID):
            for c, xm in enumerate(self.X_GRID):
                inside = line_dist(Xs, float(xm), float(ym), 2) <= 0
                assert cum[r, c] == inside.sum(), (r, c)

    def test_fetch_matches_host_2d_iterate(self, sc, host_condensed):
        from poppunk_tpu.ops.boundary import threshold_iterate_2d
        from poppunk_tpu.scale import sweep2d_fetch_streaming

        scale = host_condensed.max(axis=0)
        Xs = (host_condensed / scale).astype(np.float32)
        x_caps = np.full(len(self.Y_GRID), self.X_GRID[-1], np.float32)
        i, j, xs, ys = sweep2d_fetch_streaming(sc, scale, x_caps,
                                               self.Y_GRID)
        for r, ym in enumerate(self.Y_GRID):
            hi, hj, hidx = threshold_iterate_2d(Xs, self.X_GRID, float(ym))
            # reconstruct first x offsets from the fetched coordinates
            # (refine_fit_device_2d's formula)
            with np.errstate(divide="ignore", invalid="ignore"):
                t = np.where(ys < ym,
                             xs.astype(np.float64) * ym / (ym - ys),
                             np.inf)
            idx = np.searchsorted(self.X_GRID.astype(np.float64), t,
                                  side="left")
            keep = idx < len(self.X_GRID)
            got = sorted(zip(i[keep], j[keep], idx[keep]))
            assert got == sorted(zip(hi, hj, hidx)), r

    def test_sharded_matches_single_device(self, pop, sc, host_condensed):
        """Row-sharded 2-D passes over the mesh equal the single-device
        streaming twin exactly (counts and in-union fetch)."""
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import (StreamingCondensed,
                                       sweep2d_counts_streaming,
                                       sweep2d_fetch_streaming)

        mesh = get_mesh(len(jax.devices()))
        scm = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                 KLIST, SS64, BBITS, chunk=4, knn=1,
                                 mesh=mesh)
        scale = host_condensed.max(axis=0)
        a = sweep2d_counts_streaming(scm, scale, self.X_GRID, self.Y_GRID)
        b = sweep2d_counts_streaming(sc, scale, self.X_GRID, self.Y_GRID)
        assert np.array_equal(a, b)
        x_caps = np.full(len(self.Y_GRID), self.X_GRID[-1], np.float32)
        mi, mj, mx, my = sweep2d_fetch_streaming(scm, scale, x_caps,
                                                 self.Y_GRID)
        si, sj, sx, sy = sweep2d_fetch_streaming(sc, scale, x_caps,
                                                 self.Y_GRID)
        assert np.array_equal(mi, si) and np.array_equal(mj, sj)
        np.testing.assert_allclose(mx, sx, rtol=1e-6)
        np.testing.assert_allclose(my, sy, rtol=1e-6)

    def test_refine_2d_recovers_boundary(self, pop, sc, host_condensed):
        """End-to-end 2-D refinement separates the planted strains."""
        from poppunk_tpu.network.graph import Graph
        from poppunk_tpu.network.components import connected_components
        from poppunk_tpu.scale import refine_fit_device_2d
        from sklearn.metrics import adjusted_rand_score

        scale = host_condensed.max(axis=0)
        # means from the planted structure: within/between blob centres
        same = pop.strain[np.newaxis, :] == pop.strain[:, np.newaxis]
        from poppunk_tpu.pairs import all_pairs

        ii, jj = all_pairs(N)
        w = same[ii, jj]
        Xs = host_condensed / scale
        mean0 = Xs[w].mean(axis=0)
        mean1 = Xs[~w].mean(axis=0)
        ox, oy, sweep = refine_fit_device_2d(sc, scale, mean0, mean1,
                                             max_move=0.0, seed=5)
        _, i, j, xs, ys = sweep
        mask = ys * np.float32(ox) + xs * np.float32(oy) \
            - np.float32(ox) * np.float32(oy) <= 0
        edges = np.stack([i[mask], j[mask]], axis=1)
        labels = connected_components(Graph(N, edges))[0]
        # refine may split a strain into sub-cliques; clusters must be
        # strain-PURE and close to the planted structure
        assert adjusted_rand_score(pop.strain, labels) > 0.9
        for cl in np.unique(labels):
            assert len(np.unique(pop.strain[labels == cl])) == 1


class TestRaggedDispatchPlan:
    """A dispatch budget that doesn't divide the step count produces a
    smaller tail group; every pass must still equal the single-dispatch
    result (and the plan must never degrade to 1-step dispatches)."""

    def test_plan_shapes(self):
        from poppunk_tpu import scale as sc

        plan = sc._dispatch_plan(32, 4, 64, cap_rows=12)
        assert plan == [(0, 3), (3, 3), (6, 2)]
        assert sc._dispatch_plan(32, 4, 64) == [(0, 8)]

    def test_ragged_equals_single_dispatch(self, pop, monkeypatch):
        import jax

        from poppunk_tpu import scale as sc
        from poppunk_tpu.parallel.mesh import get_mesh

        kwargs = dict(chunk=4, knn=3, subsample=(100, 7),
                      use_pallas=False)
        ref = sc.StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                    KLIST, SS64, BBITS, **kwargs)
        scale = ref.max_scale()
        offsets = np.linspace(0.0, 0.5, 10)
        args1d = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        want = sweep_first_offsets(ref, *args1d)
        want_counts = sc.sweep_counts_streaming(ref, *args1d)

        # budget of 3 chunks per dispatch: n_steps=8 -> groups 3,3,2
        monkeypatch.setattr(sc, "PAIRS_PER_DISPATCH", 3 * 4 * 2 * N)
        for mesh in (None, get_mesh(len(jax.devices()))):
            cd = sc.StreamingCondensed(pop.planes, pop.lengths,
                                       pop.freqs, KLIST, SS64, BBITS,
                                       mesh=mesh, **kwargs)
            assert np.array_equal(cd.knn_col, ref.knn_col)
            assert np.array_equal(cd.subsample_pairs(100, seed=7),
                                  ref.subsample_pairs(100, seed=7))
            got = sweep_first_offsets(cd, *args1d)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
            assert np.array_equal(
                sc.sweep_counts_streaming(cd, *args1d), want_counts)


class TestMeshCompactPasses:
    """QC and fixed-boundary compaction passes sharded over the mesh
    equal the single-device twins exactly."""

    def test_qc_pairs_sharded(self, pop, host_condensed):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import qc_bad_pairs_streaming

        args = (pop.planes, pop.lengths, pop.freqs, KLIST, SS64, BBITS,
                4, N, 0.05, 0.3)
        si, sj, sf = qc_bad_pairs_streaming(*args, use_pallas=False)
        mi, mj, mf = qc_bad_pairs_streaming(
            *args, use_pallas=False, mesh=get_mesh(len(jax.devices())))
        assert np.array_equal(mi, si) and np.array_equal(mj, sj)
        assert np.array_equal(mf, sf)
        # and both match the host matrix rule
        bad = ((host_condensed[:, 0] > 0.05)
               | (host_condensed[:, 1] > 0.3)).sum()
        zero = ((host_condensed[:, 0] == 0)
                | (host_condensed[:, 1] == 0)).sum()
        assert ((sf & 1) > 0).sum() == bad
        assert ((sf & 2) > 0).sum() == zero

    def test_boundary_fetch_sharded(self, pop, host_condensed):
        import jax

        from poppunk_tpu.ops.boundary import edge_iterate
        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import fetch_within_boundary

        scale = host_condensed.max(axis=0)
        args = (pop.planes, pop.lengths, pop.freqs, KLIST, SS64, BBITS,
                4, N, scale, 0.4, 0.5, 2)
        si, sj = fetch_within_boundary(*args, use_pallas=False)
        mi, mj = fetch_within_boundary(
            *args, use_pallas=False, mesh=get_mesh(len(jax.devices())))
        assert np.array_equal(mi, si) and np.array_equal(mj, sj)
        # host oracle: assign_threshold's edge rule on the scaled matrix
        edges = edge_iterate(host_condensed / scale, 2, 0.4, 0.5)
        assert sorted(zip(si, sj)) == sorted(map(tuple, edges))

    def test_qc_pairs_col_sharded(self, pop):
        # the column-sharded compact pass (shard_planes) returns the
        # same lexsorted (i, j, flags) as the row-sharded/single paths
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import qc_bad_pairs_streaming

        args = (pop.planes, pop.lengths, pop.freqs, KLIST, SS64, BBITS,
                4, N, 0.05, 0.3)
        si, sj, sf = qc_bad_pairs_streaming(*args, use_pallas=False)
        ci, cj, cf = qc_bad_pairs_streaming(
            *args, use_pallas=False, mesh=get_mesh(len(jax.devices())),
            shard_planes=True)
        assert np.array_equal(ci, si) and np.array_equal(cj, sj)
        assert np.array_equal(cf, sf)

    def test_boundary_fetch_col_sharded(self, pop, host_condensed):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import fetch_within_boundary

        scale = host_condensed.max(axis=0)
        args = (pop.planes, pop.lengths, pop.freqs, KLIST, SS64, BBITS,
                4, N, scale, 0.4, 0.5, 2)
        si, sj = fetch_within_boundary(*args, use_pallas=False)
        ci, cj = fetch_within_boundary(
            *args, use_pallas=False, mesh=get_mesh(len(jax.devices())),
            shard_planes=True)
        # col pairs come back grouped by owning device: set equality
        assert sorted(zip(ci, cj)) == sorted(zip(si, sj))


class TestArbitraryPadStreaming:
    """Arbitrary zero-genome padding (pack_planes pad_to): real-world
    populations pad up to the folded layout's chunk granularity
    (cli/scale.py), so n - n_real can be any gap, not just 1. All pads
    must be exactly masked, single-device and mesh-sharded alike."""

    N_REAL = 61

    def _padded(self, pop, n_pad):
        planes = np.asarray(pop.planes)[:, :, :self.N_REAL, :]
        planes_pad = np.zeros(
            planes.shape[:2] + (n_pad,) + planes.shape[3:], np.uint32)
        planes_pad[:, :, :self.N_REAL] = planes
        lengths = np.full(n_pad, 2_000_000, np.int32)
        lengths[:self.N_REAL] = np.asarray(pop.lengths)[:self.N_REAL]
        freqs = np.full((n_pad, 4), 0.25, np.float32)
        freqs[:self.N_REAL] = np.asarray(pop.freqs)[:self.N_REAL]
        return jnp.asarray(planes_pad), lengths, freqs

    @pytest.fixture(scope="class")
    def oracle(self, pop):
        planes = np.asarray(pop.planes)[:, :, :self.N_REAL, :]
        return condensed_self_block(
            np.moveaxis(planes, 2, 0),
            np.asarray(pop.lengths)[:self.N_REAL],
            np.asarray(pop.freqs)[:self.N_REAL], KLIST, SS64, BBITS)

    def _check(self, sc, oracle):
        assert sc.n == self.N_REAL
        assert sc.n_pairs == len(oracle)
        h_rows, h_cols, h_dists = knn_from_condensed(
            oracle[:, 0], self.N_REAL, 5)
        rows, cols, dists = sc.knn_sparse()
        assert np.array_equal(rows, h_rows)
        np.testing.assert_allclose(dists, h_dists, rtol=1e-5, atol=1e-7)
        assert (cols < self.N_REAL).all()
        np.testing.assert_allclose(sc.max_scale(), oracle.max(axis=0),
                                   rtol=1e-6)
        scale = oracle.max(axis=0)
        offsets = np.linspace(0.0, 0.5, 20)
        hi, hj, hidx = threshold_iterate_1d_fast(
            oracle / scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        si, sj, sidx, _ = sweep_first_offsets(sc, scale, offsets, 2,
                                              0.1, 0.1, 0.7, 0.7)
        assert sorted(zip(hi, hj, hidx)) == sorted(zip(si, sj, sidx))
        assert (si < self.N_REAL).all() and (sj < self.N_REAL).all()

    def test_single_device_gap11(self, pop, oracle):
        from poppunk_tpu.scale import StreamingCondensed

        planes, lengths, freqs = self._padded(pop, 72)  # half=36, chunk 4
        sc = StreamingCondensed(planes, lengths, freqs, KLIST, SS64,
                                BBITS, chunk=4, knn=5, subsample=(150, 3),
                                n_real=self.N_REAL)
        self._check(sc, oracle)

    def test_sharded_gap19(self, pop, oracle):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        n_dev = len(jax.devices())
        if (80 // 2) % n_dev:
            pytest.skip("needs a device count dividing 40")
        planes, lengths, freqs = self._padded(pop, 80)  # half_loc=5
        sc = StreamingCondensed(planes, lengths, freqs, KLIST, SS64,
                                BBITS, chunk=5, knn=5, subsample=(150, 3),
                                n_real=self.N_REAL, mesh=get_mesh(n_dev))
        self._check(sc, oracle)

    def test_col_sharded_gap19(self, pop, oracle):
        # column-sharded padded population: pads live INSIDE the last
        # device's column shard and must be masked out of kNN, owned-pair
        # reductions and fetches (n_lim masks in _ColShardedStream)
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        n_dev = len(jax.devices())
        if 80 % n_dev or (80 // 2) % 5:
            pytest.skip("needs a device count dividing 80")
        planes, lengths, freqs = self._padded(pop, 80)
        sc = StreamingCondensed(planes, lengths, freqs, KLIST, SS64,
                                BBITS, chunk=5, knn=5, subsample=(150, 3),
                                n_real=self.N_REAL, mesh=get_mesh(n_dev),
                                shard_planes=True)
        self._check(sc, oracle)


@pytest.mark.slow
class TestManyStrainStreaming:
    """The >20480-tier regime at CPU scale: many strains, capped sweep,
    separable margins — the exact configuration the 65k device bench runs
    (auto n_strains=n/640, subsample=5n, streaming, max_sweep_fetch)."""

    def test_recovers_many_strains(self):
        out = run_scale_pipeline(
            n=1024, klist=(13, 15, 17, 19, 21, 23), sketchsize64=64,
            bbits=8, n_strains=32, chunk=32, knn=3, subsample=5 * 1024,
            seed=7, streaming=True, max_sweep_fetch=40_000,
            synth_kwargs=dict(strain_div=(0.015, 0.03),
                              accessory_strain=(0.55, 0.75)),
            log=lambda m: None)
        assert out["ari"] == 1.0
        assert out["n_clusters"] == 32


class TestShardedStreaming:
    """StreamingCondensed over the 8-device mesh == single-device."""

    @pytest.fixture(scope="class")
    def ssc(self, pop):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        mesh = get_mesh(len(jax.devices()))
        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=4, knn=5,
                                  subsample=(200, 3), mesh=mesh)

    def test_knn_and_scale_match(self, ssc, cd):
        assert np.array_equal(ssc.knn_col, cd.knn_col)
        assert np.array_equal(ssc.knn_dist, cd.knn_dist)
        np.testing.assert_allclose(ssc.max_scale(), cd.max_scale(),
                                   rtol=1e-6)

    def test_predeclared_subsample_matches(self, ssc, cd):
        assert np.array_equal(ssc.subsample_pairs(200, seed=3),
                              cd.subsample_pairs(200, seed=3))

    def test_sweep_matches_single_device(self, ssc, pop, cd):
        from poppunk_tpu.scale import (StreamingCondensed,
                                       sweep_counts_streaming)

        sc1 = StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                 KLIST, SS64, BBITS, chunk=4, knn=5)
        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        assert np.array_equal(sweep_counts_streaming(ssc, *args),
                              sweep_counts_streaming(sc1, *args))
        si, sj, sidx, sd0 = sweep_first_offsets(sc1, *args)
        mi, mj, midx, md0 = sweep_first_offsets(ssc, *args)
        assert np.array_equal(mi, si)
        assert np.array_equal(mj, sj)
        assert np.array_equal(midx, sidx)
        np.testing.assert_allclose(md0, sd0, rtol=1e-6, atol=1e-7)


class TestColShardedStreaming:
    """shard_planes=True StreamingCondensed == single-device streaming.

    Column-sharded: the planes split over the genome axis (the 128k+
    tier, where a REPLICATED plane tensor overflows per-device HBM);
    every device walks all folded chunks and owns its column slice.
    Fetch order differs from the folded single-device order (pairs come
    back grouped by owning device), so fetches compare as sorted sets.
    """

    @pytest.fixture(scope="class")
    def sc1(self, pop):
        from poppunk_tpu.scale import StreamingCondensed

        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=4, knn=5,
                                  subsample=(200, 3))

    @pytest.fixture(scope="class")
    def csc(self, pop):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import StreamingCondensed

        mesh = get_mesh(len(jax.devices()))
        return StreamingCondensed(pop.planes, pop.lengths, pop.freqs,
                                  KLIST, SS64, BBITS, chunk=4, knn=5,
                                  subsample=(200, 3), mesh=mesh,
                                  shard_planes=True)

    def test_knn_and_scale_match(self, csc, sc1):
        # distances are allclose, not bit-equal: the col-sharded program
        # compiles with n_loc-wide tiles, so XLA may reassociate the
        # correction epilogue's small reductions differently than the
        # full-width program (measured 2e-7 relative on CPU). Neighbour
        # ranks computed on such floats may therefore SWAP at near-ties:
        # indices must agree except where the two candidates' distances
        # are within the reassociation tolerance
        mism = csc.knn_col != sc1.knn_col
        if mism.any():
            np.testing.assert_allclose(csc.knn_dist[mism],
                                       sc1.knn_dist[mism],
                                       rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(csc.knn_dist, sc1.knn_dist,
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(csc.max_scale(), sc1.max_scale(),
                                   rtol=1e-6)

    def test_predeclared_subsample_matches(self, csc, sc1):
        np.testing.assert_allclose(csc.subsample_pairs(200, seed=3),
                                   sc1.subsample_pairs(200, seed=3),
                                   rtol=1e-4, atol=5e-6)

    def test_recomputed_subsample_matches(self, csc, sc1):
        # a (size, seed) NOT predeclared exercises the pair_dists
        # cross-shard gather path
        np.testing.assert_allclose(
            csc.subsample_pairs(64, seed=11, block=32),
            sc1.subsample_pairs(64, seed=11, block=32),
            rtol=1e-4, atol=5e-6)

    def test_sweep_matches_single_device(self, csc, sc1, cd):
        from poppunk_tpu.scale import sweep_counts_streaming

        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 20)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        assert np.array_equal(sweep_counts_streaming(csc, *args),
                              sweep_counts_streaming(sc1, *args))
        si, sj, sidx, sd0 = sweep_first_offsets(sc1, *args)
        mi, mj, midx, md0 = sweep_first_offsets(csc, *args)
        o_s = np.lexsort((sj, si))
        o_m = np.lexsort((mj, mi))
        assert np.array_equal(mi[o_m], si[o_s])
        assert np.array_equal(mj[o_m], sj[o_s])
        assert np.array_equal(midx[o_m], sidx[o_s])
        np.testing.assert_allclose(md0[o_m], sd0[o_s], rtol=1e-4,
                                   atol=1e-5)

    def test_sweep2d_matches_single_device(self, csc, sc1, cd):
        from poppunk_tpu.scale import (sweep2d_counts_streaming,
                                       sweep2d_fetch_streaming)

        scale = cd.max_scale()
        xg = np.linspace(0.05, 0.9, 6)
        yg = np.linspace(0.05, 0.9, 6)
        assert np.array_equal(sweep2d_counts_streaming(csc, scale, xg, yg),
                              sweep2d_counts_streaming(sc1, scale, xg, yg))
        caps = np.where(np.arange(6) % 2 == 0, xg, 0.0)
        si, sj, sx, sy = sweep2d_fetch_streaming(sc1, scale, caps, yg)
        mi, mj, mx, my = sweep2d_fetch_streaming(csc, scale, caps, yg)
        o_s = np.lexsort((sj, si))
        o_m = np.lexsort((mj, mi))
        assert np.array_equal(mi[o_m], si[o_s])
        assert np.array_equal(mj[o_m], sj[o_s])
        np.testing.assert_allclose(mx[o_m], sx[o_s], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(my[o_m], sy[o_s], rtol=1e-4, atol=1e-5)

    def test_hbm_accounting(self):
        # the shard_planes auto-switch arithmetic: at 131072 genomes /
        # production geometry, replicated planes pass the (CPU test
        # budget's) replication cap; column-sharded over 8 devices they
        # fit with room for the tile
        from poppunk_tpu.memory import memory_plan
        from poppunk_tpu.scale import streaming_hbm_accounting

        prod = dict(klist=(13, 16, 19, 22, 25, 28), sketchsize64=156,
                    bbits=14, chunk=256, knn=5, n_dev=8)
        rep = streaming_hbm_accounting(131072, shard_planes=False, **prod)
        col = streaming_hbm_accounting(131072, shard_planes=True, **prod)
        plan = memory_plan()
        assert rep["planes"] > plan.replicated_planes_max  # replicated: no
        assert col["total"] < plan.replicated_planes_max  # sharded: fits
        # sharding splits exactly
        assert col["planes"] * prod["n_dev"] == rep["planes"]


class TestShardedFill:
    """fill_condensed_sharded over the 8-device mesh == single-device fill."""

    def test_matches_single_device(self, pop, cd):
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import fill_condensed_sharded

        mesh = get_mesh(len(jax.devices()))
        cds = fill_condensed_sharded(pop.planes, pop.lengths, pop.freqs,
                                     KLIST, SS64, BBITS, mesh=mesh,
                                     chunk=4, knn=5)
        assert np.array_equal(np.asarray(cds.buf), np.asarray(cd.buf))
        assert np.array_equal(cds.knn_col, cd.knn_col)
        assert np.array_equal(cds.knn_dist, cd.knn_dist)

    def test_consumers_on_sharded_buffer(self, pop, cd):
        """sweep_first_offsets / max_scale work unchanged on the sharded
        buffer (shard-transparent consumers)."""
        import jax

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import fill_condensed_sharded

        mesh = get_mesh(len(jax.devices()))
        cds = fill_condensed_sharded(pop.planes, pop.lengths, pop.freqs,
                                     KLIST, SS64, BBITS, mesh=mesh,
                                     chunk=4, knn=5)
        np.testing.assert_allclose(cds.max_scale(), cd.max_scale())
        scale = cd.max_scale()
        offsets = np.linspace(0.0, 0.5, 8)
        args = (scale, offsets, 2, 0.1, 0.1, 0.7, 0.7)
        di, dj, didx, dd0 = sweep_first_offsets(cd, *args)
        si, sj, sidx, sd0 = sweep_first_offsets(cds, *args)
        assert sorted(zip(di, dj, didx)) == sorted(zip(si, sj, sidx))

    def test_rejects_indivisible(self, pop):
        import pytest as _pytest

        from poppunk_tpu.parallel.mesh import get_mesh
        from poppunk_tpu.scale import fill_condensed_sharded

        mesh = get_mesh(3)
        with _pytest.raises(ValueError, match="multiple of the device"):
            fill_condensed_sharded(pop.planes, pop.lengths, pop.freqs,
                                   KLIST, SS64, BBITS, mesh=mesh)
