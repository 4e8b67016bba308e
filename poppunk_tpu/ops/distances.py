"""Device-side sketch distance computation.

This is the performance core of the framework — the device replacement
for pp-sketchlib's all-vs-all / query-vs-ref distance engine (invoked by the
reference at PopPUNK/sketchlib.py:528-537). Pipeline, fully fused under one
jit per query chunk:

    packed bit-plane sketches (uint32)
      -> bin match counts        (XNOR, AND over planes, popcount)   [kernel]
      -> b-bit collision + random-match corrected Jaccard per k
      -> constrained log-linear fit across k
      -> (core, accessory) per pair

Two bin-match implementations with identical semantics, chosen by
ops/match_kernel.match_counts:
  * ``match_counts_xla`` / ``match_counts_xla_t`` — plain jnp, the CPU
    route and the reference the kernel is tested against;
  * the Pallas Triton kernel in ops/match_kernel.py, the GPU route.

Device layout: ``planes[n, K, P, Wp]`` uint32, where K = len(klist),
P = bbits, Wp = 2*sketchsize64 zero-padded up to a multiple of the kernel's
word chunk. Zero padding in both operands XNORs to all-ones through every
plane, adding a constant (pad words * 32) to each raw count, which is
subtracted.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmer_fit import _fit_math
from .match_kernel import WORD_CHUNK, match_counts, use_kernel


def plane_geometry(sketchsize64, bbits):
    """(real words w32, padded words Wp, pad bits) of one plane row: the
    word axis is padded only to the bin-match kernel's word chunk."""
    w32 = 2 * sketchsize64
    wp = -(-w32 // WORD_CHUNK) * WORD_CHUNK
    pad_bits = (wp - w32) * 32
    return w32, wp, pad_bits


def pack_planes(sketches, klist=None, plane_major=False,
                pad_to_even=False, pad_to=None):
    """Pack Sketch objects into the device plane tensor.

    Returns (planes uint32[n, K, P, Wp], lengths int32[n], freqs f32[n, 4]).

    HDF5 usigs are uint64[sketchsize64 * bbits] in interleaved plane-minor
    layout (word w, plane p at index w*bbits + p); on device we use
    plane-major [P, W] with each uint64 split into (low32, high32).

    plane_major=True emits [K, P, n, Wp] — the layout the scale pipeline
    (poppunk_tpu/scale.py) keeps resident. pad_to_even appends one
    all-zero pad genome when n is odd (the folded condensed layout needs
    even n); pad_to=m pads with zero genomes up to an arbitrary m >= n
    (so real-world populations meet the folded layout's chunk-divisibility
    requirement, poppunk_tpu/cli/scale.py); StreamingCondensed masks the
    pads exactly via n_real.
    """
    ss64 = sketches[0].sketchsize64
    bbits = sketches[0].bbits
    if klist is None:
        klist = sorted(sketches[0].usigs.keys())
    w32, wp, _ = plane_geometry(ss64, bbits)
    n_real = len(sketches)
    if pad_to is not None:
        if pad_to < n_real:
            raise ValueError(f"pad_to ({pad_to}) < population ({n_real})")
        n = int(pad_to)
    else:
        n = n_real + (n_real % 2 if pad_to_even else 0)
    shape = ((len(klist), bbits, n, wp) if plane_major
             else (n, len(klist), bbits, wp))
    planes = np.zeros(shape, dtype=np.uint32)
    lengths = np.zeros(n, dtype=np.int32)
    freqs = np.zeros((n, 4), dtype=np.float32)
    if n > n_real:  # pad genome: zero sketch, innocuous metadata
        lengths[n_real:] = 2_000_000
        freqs[n_real:] = 0.25
    for i, sk in enumerate(sketches):
        if sk.sketchsize64 != ss64 or sk.bbits != bbits:
            raise ValueError("Inconsistent sketch geometry")
        lengths[i] = sk.length
        freqs[i] = sk.base_freq
        for ki, k in enumerate(klist):
            u = sk.usigs[int(k)].reshape(ss64, bbits).T  # [P, ss64] uint64
            lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            hi = (u >> np.uint64(32)).astype(np.uint32)
            interleaved = np.empty((bbits, w32), dtype=np.uint32)
            interleaved[:, 0::2] = lo
            interleaved[:, 1::2] = hi
            if plane_major:
                planes[ki, :, i, :w32] = interleaved
            else:
                planes[i, ki, :, :w32] = interleaved
    return planes, lengths, freqs


def unpack_planes(planes, lengths, freqs, klist, sketchsize64, names,
                  plane_major=False):
    """Inverse of pack_planes: Sketch objects from a plane tensor (host
    arrays), one per name, for genomes [0, len(names))."""
    from ..sketch.minhash import Sketch

    planes = np.asarray(planes)
    if not plane_major:
        planes = planes.transpose(1, 2, 0, 3)  # [K, P, n, Wp]
    n = len(names)
    bbits = planes.shape[1]
    w32 = 2 * sketchsize64
    usigs = []
    for ki in range(len(klist)):
        words = np.ascontiguousarray(planes[ki, :, :n, :w32])  # [P, n, w32]
        u = words.view(np.uint64)  # little-endian (low32, high32) pairs
        usigs.append(np.ascontiguousarray(u.transpose(1, 2, 0))
                     .reshape(n, sketchsize64 * bbits))
    lengths = np.asarray(lengths)
    freqs = np.asarray(freqs)
    return [Sketch(name=name,
                   usigs={int(k): usigs[ki][i] for ki, k in enumerate(klist)},
                   sketchsize64=sketchsize64, bbits=bbits,
                   length=int(lengths[i]), missing_bases=0,
                   base_freq=freqs[i].astype(np.float64))
            for i, name in enumerate(names)]


def match_counts_xla(planes_q, planes_r, pad_bits):
    """Bin match counts, pure jnp. [nq,K,P,Wp] x [nr,K,P,Wp] -> i32[nq,nr,K].

    Processes query rows one at a time under vmap to bound the intermediate
    to [nr, K, P, Wp].
    """
    pq = planes_q.astype(jnp.uint32)
    pr = planes_r.astype(jnp.uint32)

    def one_q(q_planes):  # [K, P, Wp]
        agree = ~(q_planes[None] ^ pr)  # [nr, K, P, Wp]
        allp = jax.lax.reduce(
            agree,
            jnp.uint32(0xFFFFFFFF),
            jax.lax.bitwise_and,
            dimensions=(2,),
        )  # [nr, K, Wp]
        counts = jax.lax.population_count(allp).astype(jnp.int32)
        return counts.sum(axis=-1) - (pad_bits)  # [nr, K]

    return jax.lax.map(one_q, pq)  # [nq, nr, K]


def match_counts_xla_t(planes_q, planes_r, pad_bits):
    """Plane-major twin of match_counts_xla:
    [K,P,nq,Wp] x [K,P,nr,Wp] -> i32[nq,nr,K].

    The scale pipeline (poppunk_tpu/scale.py) keeps sketches resident in
    this plane-major layout so no per-call transpose of the full
    reference tensor is ever materialised (at 65k genomes that transpose
    is a second 8.4 GB copy).
    """
    pq = planes_q.astype(jnp.uint32)
    pr = planes_r.astype(jnp.uint32)

    def one_q(q_planes):  # [K, P, Wp]
        agree = ~(q_planes[:, :, None, :] ^ pr)  # [K, P, nr, Wp]
        allp = jax.lax.reduce(
            agree,
            jnp.uint32(0xFFFFFFFF),
            jax.lax.bitwise_and,
            dimensions=(1,),
        )  # [K, nr, Wp]
        counts = jax.lax.population_count(allp).astype(jnp.int32)
        return counts.sum(axis=-1).T - pad_bits  # [nr, K]

    return jax.lax.map(one_q, pq.transpose(2, 0, 1, 3))  # [nq, nr, K]


def _random_jaccard_jnp(k, len_q, len_r, freq_q, freq_r, use_rc=True):
    """Expected random Jaccard, jnp twin of sketch/random_match.py."""
    # HIGHEST: a reduced-precision default (bf16 or TF32 passes) injects
    # ~4e-3 relative noise into the match probability, which the k-mer
    # curve fit then amplifies; these dots are 4-wide — exact f32 is free
    m_f = jnp.matmul(freq_q, freq_r.T,
                     precision=jax.lax.Precision.HIGHEST)  # [nq, nr]
    p = m_f ** k
    if use_rc:
        # ACGT reversed = complement perm
        m_rc = jnp.matmul(freq_q, freq_r[:, ::-1].T,
                          precision=jax.lax.Precision.HIGHEST)
        p = p + m_rc ** k
    n1 = jnp.maximum(len_q.astype(jnp.float32) - k + 1, 1.0)[:, None]
    n2 = jnp.maximum(len_r.astype(jnp.float32) - k + 1, 1.0)[None, :]
    inter = n1 * n2 * p
    union = n1 + n2 - inter
    r = jnp.where(union <= 0, 1.0, inter / jnp.maximum(union, 1e-30))
    return jnp.clip(r, 0.0, 1.0 - 1e-6)


def corrected_jaccards(matches, klist, len_q, len_r, freq_q, freq_r,
                       sketchsize64, bbits, random_correct=True, use_rc=True):
    """matches i32[nq,nr,K] -> corrected Jaccard f32[nq,nr,K]."""
    nbins = sketchsize64 * 64
    expected = 2.0 ** (-bbits)
    obs = matches.astype(jnp.float32) / nbins
    j = jnp.clip((obs - expected) / (1.0 - expected), 0.0, 1.0)
    if random_correct:
        rs = []
        for ki, k in enumerate(klist):
            r = _random_jaccard_jnp(float(k), len_q, len_r, freq_q, freq_r, use_rc)
            rs.append(r)
        r = jnp.stack(rs, axis=-1)
        j = jnp.clip((j - r) / (1.0 - r), 0.0, 1.0)
    return j


def core_accessory(jaccards, klist):
    """Fit the k-mer curve for every pair: [..., K] -> f32[..., 2]."""
    core, acc = _fit_math(jnp, jaccards.astype(jnp.float32), jnp.asarray(klist, jnp.float32))
    return jnp.stack([core, acc], axis=-1)


@partial(jax.jit, static_argnames=("klist", "sketchsize64", "bbits", "pad_bits",
                                   "random_correct", "use_rc", "jaccard",
                                   "use_pallas", "post_name", "post_static"))
def _dist_chunk(planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
                sketchsize64, bbits, pad_bits, random_correct, use_rc,
                jaccard, use_pallas, post_name=None, post_static=(),
                post_params=None):
    matches = match_counts(planes_q, planes_r, pad_bits,
                           use_pallas=use_pallas)
    j = corrected_jaccards(matches, klist, len_q, len_r, freq_q, freq_r,
                           sketchsize64, bbits, random_correct, use_rc)
    if jaccard:
        return j
    d = core_accessory(j, klist)
    if post_name is None:
        return d
    from .fused_assign import apply_post

    return d, apply_post(d, (post_name, post_static, post_params))


# Below this many pairs the sharding overhead outweighs the parallelism;
# route small problems through the single-device path.
_SHARD_MIN_PAIRS = 1 << 16


def pairwise_block(planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
                   sketchsize64, bbits, random_correct=True, use_rc=True,
                   jaccard=False, use_pallas=None, chunk=512,
                   use_mesh=None, post_spec=None):
    """Dense [nq, nr] distance block, chunked over queries on the host.

    Returns f32[nq, nr, 2] (core, accessory) or [nq, nr, K] Jaccards.
    With ``post_spec`` (ops/fused_assign), returns (dists, extra[nq, nr]) —
    the model classification fused into the same dispatch.

    With more than one device visible (and a big enough problem), the block
    is computed sharded over the full ('q', 'r') device mesh — reference
    shards resident per device, queries data-parallel.
    """
    if post_spec is not None and jaccard:
        raise ValueError("post_spec requires (core, accessory) output")
    if use_mesh is None:
        use_mesh = (jax.device_count() > 1
                    and planes_q.shape[0] * planes_r.shape[0]
                    >= _SHARD_MIN_PAIRS)
    if use_mesh:
        from ..parallel import get_mesh, sharded_pairwise_block

        n_dev = jax.device_count()
        n_q = 2 if n_dev % 2 == 0 and n_dev > 2 else 1
        return sharded_pairwise_block(
            get_mesh(n_dev, n_q=n_q), planes_q, planes_r, len_q, len_r,
            freq_q, freq_r, klist, sketchsize64, bbits, random_correct,
            use_rc, jaccard, use_pallas, post_spec=post_spec)
    if use_pallas is None:
        use_pallas = use_kernel()
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    post_name, post_static, post_params = post_spec or (None, (), None)
    nq = planes_q.shape[0]
    out = []
    planes_r = jnp.asarray(planes_r)
    len_r = jnp.asarray(len_r)
    freq_r = jnp.asarray(freq_r)
    for start in range(0, nq, chunk):
        sl = slice(start, min(start + chunk, nq))
        n = sl.stop - sl.start
        # Bucket the query-chunk size to the next power of two (zero-pad,
        # slice the result): every distinct batch size would otherwise
        # trace + compile its own program — O(log chunk) executables
        # instead, so serving latency is flat across batch sizes.
        bucket = 1
        while bucket < n:
            bucket *= 2
        pad = bucket - n
        pq, lq, fq = planes_q[sl], len_q[sl], freq_q[sl]
        if pad:
            pq = np.pad(np.asarray(pq), ((0, pad),) + ((0, 0),) * 3)
            lq = np.pad(np.asarray(lq), (0, pad), constant_values=1)
            fq = np.pad(np.asarray(fq), ((0, pad), (0, 0)))
        o = _dist_chunk(
            jnp.asarray(pq), planes_r, jnp.asarray(lq), len_r,
            jnp.asarray(fq), freq_r,
            tuple(int(k) for k in klist), int(sketchsize64), int(bbits),
            int(pad_bits), bool(random_correct), bool(use_rc),
            bool(jaccard), bool(use_pallas),
            post_name, post_static, post_params,
        )
        if pad:
            o = (o[0][:n], o[1][:n]) if post_name is not None else o[:n]
        out.append(o)
    if post_name is not None:
        return (np.concatenate([np.asarray(o[0]) for o in out], axis=0),
                np.concatenate([np.asarray(o[1]) for o in out], axis=0))
    return np.concatenate([np.asarray(o) for o in out], axis=0)


def condensed_self_block(planes, lengths, freqs, klist, sketchsize64, bbits,
                         random_correct=True, use_rc=True, jaccard=False,
                         use_pallas=None, chunk=512, post_spec=None):
    """Condensed i<j all-vs-all rows WITHOUT materialising the n x n
    square: each query chunk's block is sliced to its upper-triangle rows
    immediately (peak memory chunk * n instead of n * n — the difference
    between 80 GB and 0.4 GB at 10^5 genomes)."""
    n = planes.shape[0]
    out = []
    out_extra = []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        block = pairwise_block(
            planes[start:stop], planes, lengths[start:stop], lengths,
            freqs[start:stop], freqs, klist, sketchsize64, bbits,
            random_correct, use_rc, jaccard, use_pallas, chunk=chunk,
            use_mesh=False if n * (stop - start) < _SHARD_MIN_PAIRS else None,
            post_spec=post_spec)
        if post_spec is not None:
            block, extra = block
            for local, gi in enumerate(range(start, stop)):
                out_extra.append(extra[local, gi + 1:])
        for local, gi in enumerate(range(start, stop)):
            out.append(block[local, gi + 1:])
    if post_spec is not None:
        return (np.concatenate(out, axis=0),
                np.concatenate(out_extra, axis=0))
    return np.concatenate(out, axis=0)


def warmup_query_programs(sketches_r, klist, post_spec=None, chunk=512,
                          use_pallas=None, use_rc=True):
    """Pre-compile the serving programs for a reference set.

    With power-of-two chunk bucketing, the executables a serving process
    can ever need for this geometry are one per bucket size; compile them
    all against dummy queries before taking traffic, so no request pays a
    first-compile. Returns the number of programs warmed.
    """
    if use_pallas is None:
        use_pallas = use_kernel()
    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    planes_r, len_r, freq_r = pack_planes(sketches_r, klist)
    _, wp, pad_bits = plane_geometry(ss64, bbits)
    post_name, post_static, post_params = post_spec or (None, (), None)
    planes_r = jnp.asarray(planes_r)
    len_r = jnp.asarray(len_r)
    freq_r = jnp.asarray(freq_r)
    n = 0
    bucket = 1
    while True:
        pq = jnp.zeros((bucket, len(klist), bbits, wp), dtype=jnp.uint32)
        lq = jnp.ones(bucket, dtype=jnp.int32)
        fq = jnp.zeros((bucket, 4), dtype=jnp.float32)
        out = _dist_chunk(
            pq, planes_r, lq, len_r, fq, freq_r,
            tuple(int(k) for k in klist), int(ss64), int(bbits),
            int(pad_bits), True, bool(use_rc), False, bool(use_pallas),
            post_name, post_static, post_params)
        jax.block_until_ready(out)
        n += 1
        if bucket >= chunk:
            return n
        bucket *= 2


def query_db(sketches_r, sketches_q, klist, random_correct=True, use_rc=True,
             jaccard=False, self_mode=False, use_pallas=None, post_spec=None):
    """Long-form distances, reference row conventions.

    self_mode: condensed i<j rows over sketches_r (sketches_q ignored),
    matching PopPUNK/utils.py:199-226. Otherwise row = q * n_ref + r
    (PopPUNK/assign.py:690).

    Returns float32[n_rows, 2] of (core, accessory) — or [n_rows, K]
    Jaccards with jaccard=True. With ``post_spec`` (ops/fused_assign),
    returns (dists, extra[n_rows]) with the model classification fused
    into the distance dispatch.
    """
    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    planes_r, len_r, freq_r = pack_planes(sketches_r, klist)
    if self_mode:
        return condensed_self_block(
            planes_r, len_r, freq_r, klist, ss64, bbits, random_correct,
            use_rc, jaccard, use_pallas, post_spec=post_spec)
    planes_q, len_q, freq_q = pack_planes(sketches_q, klist)
    block = pairwise_block(planes_q, planes_r, len_q, len_r, freq_q, freq_r,
                           klist, ss64, bbits, random_correct, use_rc,
                           jaccard, use_pallas, post_spec=post_spec)
    if post_spec is not None:
        block, extra = block
        return block.reshape(-1, block.shape[-1]), extra.reshape(-1)
    return block.reshape(-1, block.shape[-1])
