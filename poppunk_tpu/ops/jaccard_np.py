"""NumPy reference implementation of sketch Jaccard estimation.

This is the oracle for the bin-match kernel (ops/match_kernel.py) and the
slow-but-exact host path. Semantics:

- ``matches(a, b)`` = number of bins whose bbits-bit values agree on every
  bit plane: popcount of AND over planes of XNOR of the packed words.
- b-bit collision correction: ``J = (m/S - 2^-b) / (1 - 2^-b)``, clipped at
  0 (two random sketches agree on a bin with probability 2^-b).
- optional random-match correction with the same observed-excess form:
  ``J' = (J - r) / (1 - r)`` clipped at 0, where r is the expected Jaccard
  of two random sequences with the pair's lengths and base compositions
  (see sketch/random_match.py; role matches pp-sketchlib's random_correct
  flag used at PopPUNK/sketchlib.py:533).
"""

import numpy as np


def match_counts_np(usigs_a, usigs_b, sketchsize64, bbits):
    """Bin match count between two packed sketches (uint64 words).

    usigs_* : uint64[sketchsize64 * bbits] in interleaved plane layout.
    """
    a = usigs_a.reshape(sketchsize64, bbits)
    b = usigs_b.reshape(sketchsize64, bbits)
    agree = ~(a ^ b)
    allb = np.bitwise_and.reduce(agree, axis=1)
    return int(np.bitwise_count(allb).sum())


def match_counts_block_np(planes_q, planes_r):
    """All-pairs bin match counts from plane tensors.

    planes_* : uint64[n, bbits, sketchsize64] (plane-major layout used on
    device). Returns int32[nq, nr].
    """
    nq = planes_q.shape[0]
    nr = planes_r.shape[0]
    out = np.zeros((nq, nr), dtype=np.int32)
    for i in range(nq):
        agree = ~(planes_q[i][None, :, :] ^ planes_r)  # [nr, bbits, w]
        allb = np.bitwise_and.reduce(agree, axis=1)  # [nr, w]
        out[i] = np.bitwise_count(allb).sum(axis=1).astype(np.int32)
    return out


def jaccard_from_matches(matches, sketchsize64, bbits):
    """b-bit collision corrected Jaccard estimate from bin match counts."""
    nbins = sketchsize64 * 64
    expected = 2.0 ** (-bbits)
    obs = np.asarray(matches, dtype=np.float64) / nbins
    j = (obs - expected) / (1.0 - expected)
    return np.clip(j, 0.0, 1.0)


def random_correct(jaccard, random_jaccard):
    """Observed-excess correction for random matches."""
    r = np.clip(np.asarray(random_jaccard, dtype=np.float64), 0.0, 1.0 - 1e-6)
    return np.clip((jaccard - r) / (1.0 - r), 0.0, 1.0)
