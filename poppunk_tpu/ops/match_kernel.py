"""Bin-match counting: the Hopper kernel and the one place that picks a route.

The hot loop of the framework (the reference's equivalent is the OpenMP/CUDA
popcount loop inside pp-sketchlib, called from PopPUNK/sketchlib.py:528).
For every genome pair and k-mer length,

    matches[q, r, k] = popcount( AND_p ~(Xq[k, p, :] ^ Xr[k, p, :]) )

over the real sketch words. ``AND_p ~(a_p ^ b_p) == ~OR_p (a_p ^ b_p)``, so
the kernel ORs the per-plane differences and counts the disagreeing bits
once: matches = real_bits - popcount(OR_p diff).

The kernel is written for Pallas's Triton route. Each program owns a
``[TQ, TR]`` output tile for one k-mer length and walks the word axis in
chunks of ``WORD_CHUNK`` words inside the block; for each chunk it ORs the
plane differences in registers, popcounts once and adds into an int32
accumulator. The reference chunk is reused across TQ queries and the query
chunk across TR references, which is the reuse a per-query ``lax.map`` lacks.
Programs share no state, so the grid runs in any order.

Both device layouts are read in place: genome-major ``[n, K, P, W]``
(serving) and plane-major ``[K, P, n, W]`` (the resident reference of the
scale pipeline), so neither operand is ever transposed or padded whole. Tile
edges are masked loads and stores.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Words per inner-loop step: a power of two (Triton block sizes are); the
# word axis of the plane tensors is padded to a multiple of it
# (ops/distances.plane_geometry). Production geometry (sketch size 9984,
# 312 words) needs no padding at all. Tile shape and warps: the fastest of
# a sweep on an H100 at 1024 x 10240 pairs, production geometry (PERF.md,
# "Kernel routes"); a second pipeline stage spills registers.
WORD_CHUNK = 4
TILE_Q = 64
TILE_R = 64
NUM_WARPS = 4
NUM_STAGES = 1


def _match_kernel(q_ref, r_ref, o_ref, *, bbits, n_words, total_bits, nq, nr,
                  tq, tr, wc, plane_major):
    """q_ref [P, TQ, W] (plane-major) or [TQ, P, W]; r_ref likewise with TR;
    o_ref [TQ, TR] int32 (one k-mer length of the [nq, nr, K] output)."""
    q_ok = pl.program_id(1) * tq + jnp.arange(tq) < nq
    r_ok = pl.program_id(2) * tr + jnp.arange(tr) < nr

    def plane(ref, p, words, ok):
        at = ref.at[p, :, words] if plane_major else ref.at[:, p, words]
        return plgpu.load(at, mask=ok[:, None], other=0)

    def chunk(c, acc):
        words = pl.ds(pl.multiple_of(c * wc, wc), wc)
        diff = None
        for p in range(bbits):
            x = (plane(q_ref, p, words, q_ok)[:, None, :]
                 ^ plane(r_ref, p, words, r_ok)[None, :, :])
            diff = x if diff is None else diff | x
        bits = jax.lax.population_count(diff).astype(jnp.int32)
        return acc + bits.sum(axis=2)

    diff_bits = jax.lax.fori_loop(0, n_words // wc, chunk,
                                  jnp.zeros((tq, tr), jnp.int32))
    plgpu.store(o_ref, total_bits - diff_bits,
                mask=q_ok[:, None] & r_ok[None, :])


@functools.partial(jax.jit, static_argnames=(
    "pad_bits", "plane_major", "tq", "tr", "interpret"))
def match_counts_triton(planes_q, planes_r, pad_bits, plane_major=False,
                        tq=TILE_Q, tr=TILE_R, interpret=False):
    """[nq,K,P,W] x [nr,K,P,W] (or [K,P,n,W] with plane_major) uint32
    -> int32[nq, nr, K].

    Same contract as ops/distances.match_counts_xla: ``pad_bits`` is the
    number of zero pad bits per k-mer length (pad words agree everywhere),
    so the result counts real bins only.
    """
    if plane_major:
        K, P, nq, W = planes_q.shape
        nr = planes_r.shape[2]
        q_spec = pl.BlockSpec((None, P, tq, W), lambda k, i, j: (k, 0, i, 0))
        r_spec = pl.BlockSpec((None, P, tr, W), lambda k, i, j: (k, 0, j, 0))
    else:
        nq, K, P, W = planes_q.shape
        nr = planes_r.shape[0]
        q_spec = pl.BlockSpec((tq, None, P, W), lambda k, i, j: (i, k, 0, 0))
        r_spec = pl.BlockSpec((tr, None, P, W), lambda k, i, j: (j, k, 0, 0))
    if W % WORD_CHUNK:
        raise ValueError(f"word axis {W} is not a multiple of the kernel's "
                         f"word chunk {WORD_CHUNK} (see plane_geometry)")
    kernel = functools.partial(
        _match_kernel, bbits=P, n_words=W, total_bits=W * 32 - pad_bits,
        nq=nq, nr=nr, tq=tq, tr=tr, wc=WORD_CHUNK, plane_major=plane_major)
    return pl.pallas_call(
        kernel,
        grid=(K, pl.cdiv(nq, tq), pl.cdiv(nr, tr)),
        in_specs=[q_spec, r_spec],
        out_specs=pl.BlockSpec((tq, tr, None), lambda k, i, j: (i, j, k)),
        out_shape=jax.ShapeDtypeStruct((nq, nr, K), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="bin_match",
    )(_as_int32(planes_q), _as_int32(planes_r))


def _as_int32(planes):
    # Triton's popcount lowers for signed 32-bit words (``__nv_popc``) but
    # not for unsigned ones; the bits are the same, so reinterpret
    return jax.lax.bitcast_convert_type(planes.astype(jnp.uint32), jnp.int32)


def use_kernel():
    """The bin-match route for the default backend: the Triton kernel on a
    GPU, the plain jnp version on the CPU. Never interpret mode; any other
    platform has no route."""
    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(f"no bin-match route for platform {platform!r}")


def match_counts(planes_q, planes_r, pad_bits, plane_major=False,
                 use_pallas=None):
    """Bin match counts int32[nq, nr, K] by the route ``use_pallas`` names
    (default: ``use_kernel()``); genome-major or plane-major operands."""
    if use_pallas is None:
        use_pallas = use_kernel()
    if use_pallas:
        return match_counts_triton(planes_q, planes_r, pad_bits,
                                   plane_major=plane_major)
    from .distances import match_counts_xla, match_counts_xla_t

    plain = match_counts_xla_t if plane_major else match_counts_xla
    return plain(planes_q, planes_r, pad_bits)
