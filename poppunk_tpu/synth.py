"""Device-side synthetic population sketch generator.

Generates populations of bit-plane sketches with PopPUNK-like strain
structure *directly in device memory* — no FASTA, no host genome, no
host->device upload of the O(n * sketch) tensor (set-up time that says
nothing about the distance/fit/network pipeline it feeds).

Model (three-level hierarchy of b-bit MinHash bins):

    root bins  --(strain mask, keep prob q_sk)-->  strain centroid bins
    centroid   --(genome mask, keep prob m_ik)-->  genome bins

Each genome's bin is either inherited from its strain centroid (mask
bit 1) or replaced with independent random bits (mask bit 0); masks act
per bin, i.e. the same bit position across all ``bbits`` planes. Two
genomes of one strain then agree on a bin iff both masks kept it (prob
m_ik * m_jk) or by chance (2^-bbits — exactly the random-collision floor
the distance correction removes), so the corrected Jaccard at k is

    within strain:   j(k) ~ m_ik * m_jk
    between strains: j(k) ~ m_ik * m_jk * q_sk * q_tk

With m_ik = sqrt(pi_i) * exp(-k * d_i / 2) and
q_sk = sqrt(rho_s) * exp(-k * D_s / 2), the fitted k-mer curve
(ops/kmer_fit) recovers

    core distance      (d_i + d_j) / 2              within
                       (d_i + d_j + D_s + D_t) / 2  between
    accessory distance 1 - sqrt(pi_i pi_j)              within
                       1 - sqrt(pi_i pi_j rho_s rho_t)  between

— the bimodal core/accessory cloud PopPUNK models (reference
docs/model_fitting.rst; the synthetic FASTA twin of this generator is
tests/synth_genomes.py, which this matches in spirit at 1000x the scale).

Bernoulli bits with arbitrary probability are generated by the binary-
expansion trick: for p = 0.b15 b14 ... b0 (16 bits), fold uniform random
words r_b LSB-first with ``acc = b ? (r | acc) : (r & acc)``; each step
maps P -> b/2 + P/2, so the final per-bit probability is exactly p
rounded to the nearest 1/65536. (8-bit floor quantisation is NOT enough:
its up-to-0.4% always-downward, k-dependent sawtooth error on the keep
probability m_ik biases the fitted k-mer slope — i.e. the recovered core
distance — by several 1e-3, swamping the planted within-strain
divergences.)
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ops.distances import plane_geometry

_PROB_BITS = 16


def _bernoulli_words(key, prob, shape):
    """uint32 words of independent Bernoulli(prob) bits.

    prob: array broadcastable to shape[:-1] (per-word probability, applied
    to all 32 bits of that word), rounded to the nearest 1/65536.
    """
    quant = jnp.round(
        jnp.clip(prob, 0.0, 1.0) * (1 << _PROB_BITS)).astype(jnp.uint32)
    quant = jnp.minimum(quant, (1 << _PROB_BITS) - 1)
    acc = jnp.zeros(shape, jnp.uint32)
    keys = jax.random.split(key, _PROB_BITS)
    for b in range(_PROB_BITS):
        r = jax.random.bits(keys[b], shape, jnp.uint32)
        bit = ((quant >> b) & 1) == 1
        acc = jnp.where(bit[..., None], r | acc, r & acc)
    return acc


def _keep_probs(pi, div, klist):
    """m[..., K] = sqrt(pi) * exp(-k * div / 2)."""
    return (jnp.sqrt(pi)[..., None]
            * jnp.exp(-klist[None, :] * div[..., None] / 2.0))


@partial(jax.jit, static_argnames=("shape",))
def _masked_planes(key, parents, keep_prob, shape, valid_words):
    """Derive child plane sets from parents by per-bin keep masks.

    parents: uint32 [c, K, P, Wp]; keep_prob [c, K]; returns same shape
    with pad words zeroed.
    """
    k_mask, k_rand = jax.random.split(key)
    c, K, P, Wp = shape
    mask = _bernoulli_words(k_mask, keep_prob, (c, K, Wp))
    rand = jax.random.bits(k_rand, shape, jnp.uint32)
    out = (parents & mask[:, :, None, :]) | (rand & ~mask[:, :, None, :])
    return out * valid_words


@partial(jax.jit, static_argnames=("chunk", "K", "bbits", "wp", "n"))
def _gen_all(key, nodes, valid, starts, leaf_x, m_x, chunk, K, bbits, wp,
             n):
    """All genome chunks in one dispatch: lax.scan over chunk starts.

    One dispatch instead of a per-chunk host loop. Everything
    device-sized enters as an argument — a closure-
    captured array would be baked into the program as a constant,
    defeating the persistent compile cache. Key derivation is
    fold_in(key, chunk start), identical to an unfused per-chunk loop.

    Output is PLANE-MAJOR [K, P, n, Wp] — the scale pipeline's resident
    layout (ops/match_kernel reads it in place) — written into a
    single scan-carry buffer via dynamic_update_slice. One resident copy
    only: transposing a genome-major result after the fact doubles peak
    HBM (2 x 8.4 GB at n=65536, a measured RESOURCE_EXHAUSTED).
    """

    def gen_chunk(buf, xs):
        start, leaves, m = xs
        parents = nodes[leaves]
        out = _masked_planes(jax.random.fold_in(key, start), parents,
                             m, (chunk, K, bbits, wp), valid)
        buf = jax.lax.dynamic_update_slice(
            buf, out.transpose(1, 2, 0, 3),
            (0, 0, start.astype(jnp.int32), 0))
        return buf, None

    init = jnp.zeros((K, bbits, n, wp), jnp.uint32)
    planes, _ = jax.lax.scan(gen_chunk, init, (starts, leaf_x, m_x))
    return planes


class SyntheticSketches:
    """Device-resident synthetic sketch population.

    Attributes: planes (u32 PLANE-MAJOR [K, P, n, Wp] device — the scale
    pipeline's native layout), lengths (i32 [n]), freqs (f32 [n, 4]),
    strain (int [n] host), plus the per-genome core divergences d and
    accessory retentions pi for oracle checks. planes_gm materialises
    the genome-major [n, K, P, Wp] twin (host-path oracles; small n
    only — it is a full copy).
    """

    def __init__(self, planes, lengths, freqs, strain, d, pi, klist,
                 sketchsize64, bbits):
        self.planes = planes
        self.lengths = lengths
        self.freqs = freqs
        self.strain = strain
        self.d = d
        self.pi = pi
        self.klist = klist
        self.sketchsize64 = sketchsize64
        self.bbits = bbits

    @property
    def planes_gm(self):
        """Genome-major [n, K, P, Wp] copy (test oracles; small n)."""
        return jnp.transpose(self.planes, (2, 0, 1, 3))


def synthetic_population_device(
        n, klist, sketchsize64, bbits, n_strains=20, seed=0, chunk=1024,
        core_div=(0.0008, 0.004), strain_div=(0.008, 0.02),
        accessory_within=(0.88, 0.97), accessory_strain=(0.70, 0.88),
        tree_depth=4, strain_alpha=1.5):
    """Generate n genomes' sketches on device, chunked.

    core_div / strain_div: per-genome and per-strain half-divergence
    ranges (uniform); accessory_*: bin-retention (pi / rho) ranges.

    Within each strain, genomes hang off a balanced binary coalescent of
    ``tree_depth`` levels: every internal node re-masks its parent's bins
    with a per-node divergence step (drawn from core_div / tree_depth, so
    root-to-leaf totals stay in the core_div range), and each genome adds
    a personal step below its leaf. Pairwise within-strain distances are
    then a *tree metric* — continuous, pair-structured spread — instead
    of the rank-one d_i + d_j form a flat generator yields. That matters:
    rank-one distances make the within blob a threshold graph (quasi-
    clique at any cut), which degenerates PopPUNK's transitivity*(1-
    density) refine score into preferring the tightest boundary; real
    populations (and this tree) are not cliquish under a cut.
    """
    w32, wp, _ = plane_geometry(sketchsize64, bbits)
    K = len(klist)
    kl = jnp.asarray(klist, jnp.float32)
    valid = (jnp.arange(wp) < w32).astype(jnp.uint32) * jnp.uint32(0xFFFFFFFF)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    k_root, k_strain, k_tree, k_genomes = jax.random.split(key, 4)

    # strain composition: Dirichlet sizes, per-strain divergence from
    # root. strain_alpha controls size imbalance: 1.5 gives mild spread;
    # ~0.3 gives the heavy-tailed strain-size skew of real surveillance
    # populations (a few dominant clones + a long tail of singletons)
    sizes = rng.dirichlet(np.full(n_strains, strain_alpha)) * n
    sizes = np.maximum(sizes.astype(np.int64), 1)
    while sizes.sum() != n:  # fix rounding drift
        sizes[int(rng.integers(n_strains))] += 1 if sizes.sum() < n else -1
        sizes = np.maximum(sizes, 1)
    strain = np.repeat(np.arange(n_strains), sizes)

    D_s = rng.uniform(*strain_div, n_strains)
    rho_s = rng.uniform(*accessory_strain, n_strains)

    # root + strain centroids (small: [S, K, P, Wp])
    root = jax.random.bits(k_root, (1, K, bbits, wp), jnp.uint32) * valid
    q_sk = _keep_probs(jnp.asarray(rho_s, jnp.float32),
                       jnp.asarray(D_s, jnp.float32), kl)
    centroids = _masked_planes(
        k_strain, jnp.broadcast_to(root, (n_strains, K, bbits, wp)),
        q_sk, (n_strains, K, bbits, wp), valid)

    # within-strain coalescent: split every strain centroid tree_depth
    # times (all strains share each level's [S * 2^l, K, P, Wp] dispatch)
    L = max(0, int(tree_depth))
    lvl_d = rng.uniform(*core_div, (L, n_strains << L)) / max(L, 1)
    lvl_pi = rng.uniform(*accessory_within,
                         (L, n_strains << L)) ** (1.0 / (L + 1))
    nodes = centroids
    for lev in range(L):
        m = nodes.shape[0] * 2
        d_nodes = lvl_d[lev, :m]
        pi_nodes = lvl_pi[lev, :m]
        keep = _keep_probs(jnp.asarray(pi_nodes, jnp.float32),
                           jnp.asarray(d_nodes, jnp.float32), kl)
        nodes = _masked_planes(
            jax.random.fold_in(k_tree, lev),
            jnp.repeat(nodes, 2, axis=0), keep,
            (m, K, bbits, wp), valid)

    # genome -> leaf assignment (balanced contiguous within each strain)
    leaves_per = 1 << L
    rank = np.concatenate([np.arange(c) for c in sizes])
    leaf_in_strain = rank * leaves_per // np.maximum(sizes[strain], 1)
    leaf = strain * leaves_per + leaf_in_strain

    # expected root-to-leaf divergence/retention per genome (oracle aid):
    # sum of its path steps + the personal step below the leaf
    d_path = np.zeros(n_strains << L)
    pi_path = np.ones(n_strains << L)
    for lev in range(L):
        node_of_leaf = np.arange(n_strains << L) >> (L - 1 - lev)
        d_path += lvl_d[lev, node_of_leaf]
        pi_path *= lvl_pi[lev, node_of_leaf]
    d_pers = rng.uniform(*core_div, n) / max(L, 1)
    pi_pers = rng.uniform(*accessory_within, n) ** (1.0 / (L + 1))
    d_i = d_path[leaf] + d_pers
    pi_i = pi_path[leaf] * pi_pers

    m_ik = _keep_probs(jnp.asarray(pi_pers, jnp.float32),
                       jnp.asarray(d_pers, jnp.float32), kl)
    if n % chunk:
        chunk = math.gcd(n, chunk)
    n_chunks = n // chunk
    starts = jnp.arange(n_chunks, dtype=jnp.uint32) * jnp.uint32(chunk)
    leaf_x = jnp.asarray(leaf, jnp.int32).reshape(n_chunks, chunk)
    m_x = jnp.asarray(m_ik).reshape(n_chunks, chunk, K)
    planes = _gen_all(k_genomes, nodes, valid, starts, leaf_x, m_x,
                      int(chunk), K, bbits, int(wp), int(n))

    lengths = jnp.asarray(rng.integers(1_800_000, 2_400_000, n), jnp.int32)
    freqs = jnp.asarray(rng.dirichlet([20.0, 15.0, 15.0, 20.0], n),
                        jnp.float32)
    return SyntheticSketches(planes, lengths, freqs, strain,
                             d_i, pi_i, tuple(int(k) for k in klist),
                             sketchsize64, bbits)
