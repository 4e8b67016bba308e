"""Sketching layer tests: hashes, binning, packing, HDF5 round-trip."""

import numpy as np
import pytest

from poppunk_tpu import pairs
from poppunk_tpu.ops.jaccard_np import (
    jaccard_from_matches,
    match_counts_np,
)
from poppunk_tpu.ops.kmer_fit import fit_kmer_curve_np
from poppunk_tpu.sketch.minhash import (
    EMPTY_BIN,
    SketchParams,
    bin_signs,
    densify,
    pack_bbits,
    sketch_sequence,
    unpack_bbits,
)
from poppunk_tpu.sketch.nthash import (
    encode_bases,
    nthash_canonical,
    nthash_forward,
    nthash_scalar,
)

RNG = np.random.default_rng(7)


class TestNtHash:
    def test_forward_matches_scalar(self):
        seq = RNG.integers(0, 4, 300).astype(np.uint8)
        for k in (13, 17, 28, 63, 64, 65):
            fh, valid = nthash_forward(seq, k)
            assert valid.all()
            for j in (0, 1, 63, 64, 100, len(fh) - 1):
                assert fh[j] == nthash_scalar(seq[j : j + k]), (k, j)

    def test_canonical_strand_independent(self):
        seq = RNG.integers(0, 4, 500).astype(np.uint8)
        comp = np.array([3, 2, 1, 0], dtype=np.uint8)
        rc = comp[seq][::-1].copy()
        for k in (13, 19, 31):
            h1, _ = nthash_canonical(seq, k)
            h2, _ = nthash_canonical(rc, k)
            assert np.array_equal(h1, h2[::-1])

    def test_invalid_bases_masked(self):
        seq = RNG.integers(0, 4, 100).astype(np.uint8)
        seq[50] = 4  # invalid
        _, valid = nthash_forward(seq, 13)
        assert not valid[38:51].any()
        assert valid[:38].all() and valid[51:].all()

    def test_encode(self):
        codes = encode_bases(np.frombuffer(b"ACGTacgtNX-", dtype=np.uint8))
        assert codes.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 4]


class TestMinHash:
    def test_bin_signs_min_per_bin(self):
        hashes = RNG.integers(0, 2**61 - 1, 100_000, dtype=np.uint64)
        nbins = 640
        signs = bin_signs(hashes, nbins)
        from poppunk_tpu.sketch.minhash import SIGN_MOD

        binsize = (SIGN_MOD + np.uint64(nbins) - np.uint64(1)) // np.uint64(nbins)
        s = hashes % SIGN_MOD
        expected = np.full(nbins, EMPTY_BIN, dtype=np.uint64)
        for v in s:
            b = int(v // binsize)
            expected[b] = min(expected[b], v)
        assert np.array_equal(signs, expected)

    def test_densify_fills_all(self):
        signs = np.full(640, EMPTY_BIN, dtype=np.uint64)
        signs[5] = 42
        signs[600] = 99
        dense, was = densify(signs)
        assert was
        assert (dense != EMPTY_BIN).all()
        assert set(np.unique(dense)) <= {42, 99}

    def test_densify_deterministic(self):
        signs = np.full(640, EMPTY_BIN, dtype=np.uint64)
        idx = RNG.integers(0, 640, 100)
        signs[idx] = RNG.integers(0, 2**61, 100, dtype=np.uint64)
        d1, _ = densify(signs)
        d2, _ = densify(signs)
        assert np.array_equal(d1, d2)

    def test_pack_unpack_roundtrip(self):
        signs = RNG.integers(0, 2**61, 156 * 64, dtype=np.uint64)
        packed = pack_bbits(signs, 156, 14)
        assert packed.shape == (156 * 14,)  # matches reference dataset shape
        vals = unpack_bbits(packed, 156, 14)
        assert np.array_equal(vals, signs & np.uint64((1 << 14) - 1))

    def test_self_jaccard_is_one(self):
        seq = RNG.integers(0, 4, 50_000).astype(np.uint8)
        params = SketchParams(klist=(13,))
        sk = sketch_sequence("x", seq, params)
        m = match_counts_np(sk.usigs[13], sk.usigs[13], 156, 14)
        assert m == 156 * 64
        assert jaccard_from_matches(m, 156, 14) == 1.0

    def test_related_sequences_recover_distance(self):
        L = 200_000
        base = RNG.integers(0, 4, L).astype(np.uint8)
        rate = 0.02
        pos = RNG.random(L) < rate
        mut = base.copy()
        mut[pos] = (mut[pos] + RNG.integers(1, 4, int(pos.sum()))) % 4
        params = SketchParams(klist=(13, 16, 19, 22, 25, 28))
        s1 = sketch_sequence("a", base, params)
        s2 = sketch_sequence("b", mut, params)
        jac = []
        for k in params.klist:
            m = match_counts_np(s1.usigs[k], s2.usigs[k], 156, 14)
            jac.append(jaccard_from_matches(m, 156, 14))
        # jaccard decreases with k
        assert all(a >= b - 0.02 for a, b in zip(jac, jac[1:]))
        core, acc = fit_kmer_curve_np(np.array(jac), np.array(params.klist, float))
        # model core estimate tracks the simulated SNP rate (model inflates
        # slightly because J = p_k/(2-p_k) < p_k)
        assert 0.5 * rate < core < 2.5 * rate
        # intercept soaks up the Jaccard-vs-match-probability offset
        assert acc < 0.12

    def test_unrelated_sequences_far(self):
        params = SketchParams(klist=(13, 16, 19, 22, 25, 28))
        a = sketch_sequence("a", RNG.integers(0, 4, 100_000).astype(np.uint8), params)
        b = sketch_sequence("b", RNG.integers(0, 4, 100_000).astype(np.uint8), params)
        jac = np.array(
            [
                jaccard_from_matches(
                    match_counts_np(a.usigs[k], b.usigs[k], 156, 14), 156, 14
                )
                for k in params.klist
            ]
        )
        core, acc = fit_kmer_curve_np(jac, np.array(params.klist, float))
        assert core > 0.15 or (core == 1.0 and acc == 1.0)


class TestKmerFit:
    def test_perfect_model_recovered(self):
        klist = np.array([13.0, 16.0, 19.0, 22.0, 25.0, 28.0])
        a, c = 0.2, 0.01
        j = (1 - a) * (1 - c) ** klist
        core, acc = fit_kmer_curve_np(j, klist)
        assert abs(core - c) < 1e-9
        assert abs(acc - a) < 1e-9

    def test_batch_shapes(self):
        klist = np.array([13.0, 16.0, 19.0])
        j = np.clip(RNG.random((50, 3)), 1e-3, 1)
        core, acc = fit_kmer_curve_np(j, klist)
        assert core.shape == (50,)
        assert (core >= 0).all() and (acc >= 0).all()

    def test_too_few_valid_ks(self):
        klist = np.array([13.0, 16.0, 19.0])
        core, acc = fit_kmer_curve_np(np.array([0.1, 0.0, 0.0]), klist)
        assert core == 1.0 and acc == 1.0

    def test_positive_slope_clamped(self):
        klist = np.array([13.0, 16.0, 19.0])
        # increasing jaccard with k -> slope would be positive -> clamped
        core, acc = fit_kmer_curve_np(np.array([0.1, 0.2, 0.4]), klist)
        assert core == 0.0
        assert 0 <= acc <= 1

    def test_matches_scipy_reference(self):
        """Closed form equals scipy bounded least squares (the reference's
        fitKmerCurve, PopPUNK/sketchlib.py:635-670) on valid inputs."""
        from scipy import optimize

        klist = np.array([13.0, 16.0, 19.0, 22.0, 25.0, 28.0])
        jacobian = -np.hstack((np.ones((klist.shape[0], 1)), klist.reshape(-1, 1)))
        for _ in range(50):
            j = np.clip(RNG.random(6) * 0.9 + 0.01, 1e-4, 1.0)
            fit = optimize.least_squares(
                fun=lambda p, x, y: y - (p[0] + p[1] * x),
                x0=[0.0, -0.01],
                jac=lambda p, x, y: jacobian,
                args=(klist, np.log(j)),
                bounds=([-np.inf, -np.inf], [0, 0]),
            )
            ref_core, ref_acc = np.flipud(1 - np.exp(fit.x))
            core, acc = fit_kmer_curve_np(j, klist)
            assert abs(core - ref_core) < 1e-6, (core, ref_core, j)
            assert abs(acc - ref_acc) < 1e-6, (acc, ref_acc, j)


class TestPairs:
    def test_roundtrip(self):
        n = 57
        i, j = pairs.all_pairs(n)
        assert i.shape[0] == pairs.n_pairs(n)
        assert (i < j).all()
        rows = pairs.pair_to_condensed(i, j, n)
        assert np.array_equal(rows, np.arange(pairs.n_pairs(n)))

    def test_matches_reference_iteration(self):
        # reference order: for i, for j in i+1..n (utils.py:199-226)
        n = 9
        expect = [(i, j) for i in range(n) for j in range(i + 1, n)]
        i, j = pairs.all_pairs(n)
        assert list(zip(i.tolist(), j.tolist())) == expect

    def test_square_roundtrip(self):
        n = 12
        vec = RNG.random(pairs.n_pairs(n)).astype(np.float32)
        sq = pairs.condensed_to_square(vec, n)
        assert np.array_equal(pairs.square_to_condensed_vec(sq), vec)
        assert np.array_equal(sq, sq.T)

    def test_square_multi(self):
        n_ref, n_q = 5, 3
        rr = RNG.random(pairs.n_pairs(n_ref)).astype(np.float32)
        qr = RNG.random(n_q * n_ref).astype(np.float32)
        qq = RNG.random(pairs.n_pairs(n_q)).astype(np.float32)
        sq = pairs.square_multi(rr, qr, qq, n_ref, n_q)
        assert sq.shape == (8, 8)
        assert np.array_equal(sq, sq.T)
        assert sq[5, 0] == qr.reshape(n_q, n_ref)[0, 0]


class TestMatchKernelOracle:
    """The Triton bin-match kernel (interpret mode on CPU) must equal the
    plain jnp route — including tile edges and both device layouts."""

    @staticmethod
    def _planes(nq, nr, K, bbits, ss64, seed):
        from poppunk_tpu.ops.distances import plane_geometry

        w32, wp, pad_bits = plane_geometry(ss64, bbits)
        rng = np.random.default_rng(seed)
        pq = np.zeros((nq, K, bbits, wp), dtype=np.uint32)
        pr = np.zeros((nr, K, bbits, wp), dtype=np.uint32)
        pq[..., :w32] = rng.integers(0, 2**32, (nq, K, bbits, w32),
                                     dtype=np.uint32)
        pr[..., :w32] = rng.integers(0, 2**32, (nr, K, bbits, w32),
                                     dtype=np.uint32)
        pr[: min(nq, nr) // 2] = pq[: min(nq, nr) // 2]  # exact matches
        return pq, pr, pad_bits

    @pytest.mark.parametrize("plane_major", [False, True])
    @pytest.mark.parametrize("nq,nr", [(3, 5), (64, 128), (65, 129)])
    def test_matches_xla_oracle(self, nq, nr, plane_major):
        from poppunk_tpu.ops.distances import match_counts_xla
        from poppunk_tpu.ops.match_kernel import match_counts_triton

        pq, pr, pad_bits = self._planes(nq, nr, 3, 5, 17, nq * 1000 + nr)
        want = match_counts_xla(pq, pr, pad_bits)
        if plane_major:
            pq, pr = pq.transpose(1, 2, 0, 3), pr.transpose(1, 2, 0, 3)
        got = match_counts_triton(pq, pr, pad_bits, plane_major=plane_major,
                                  tq=16, tr=32, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    @pytest.mark.parametrize("K", [5, 6])
    def test_production_geometry_unpadded(self, K):
        """Sketch size 9984, bbits 14: 312 words per plane row, a whole
        number of word chunks, so no padding at all."""
        from poppunk_tpu.ops.distances import match_counts_xla, plane_geometry
        from poppunk_tpu.ops.match_kernel import match_counts_triton

        assert plane_geometry(156, 14) == (312, 312, 0)
        pq, pr, pad_bits = self._planes(5, 9, K, 14, 156, K)
        got = match_counts_triton(pq, pr, pad_bits, tq=8, tr=16,
                                  interpret=True)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(match_counts_xla(pq, pr, pad_bits)))
