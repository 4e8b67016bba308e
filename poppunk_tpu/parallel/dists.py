"""Sharded all-vs-all / query-vs-reference distances over a device mesh.

Multi-device replacement for pp-sketchlib's single-device distance engine
(reference call site PopPUNK/sketchlib.py:528-537): the packed reference
sketch tensor is sharded along the mesh ``r`` axis, query batches along the
``q`` axis, and every device computes the (query shard x reference shard)
distance tile locally — zero cross-device traffic in the steady state; the
only collective is the output gather, which XLA emits as all-gathers when
the caller asks for a replicated result.

Works on any mesh size including 1 device (where it degrades to the plain
single-device kernel path).
"""

from functools import partial

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.distances import core_accessory, corrected_jaccards, plane_geometry
from ..ops.match_kernel import match_counts, use_kernel


def _local_block(pq, pr, lq, lr, fq, fr, post_params, *, klist, sketchsize64,
                 bbits, pad_bits, random_correct, use_rc, jaccard, use_pallas,
                 post_name, post_static):
    """Distance tile for one device's (query shard, reference shard)."""
    matches = match_counts(pq, pr, pad_bits, use_pallas=use_pallas)
    j = corrected_jaccards(matches, klist, lq, lr, fq, fr,
                           sketchsize64, bbits, random_correct, use_rc)
    if jaccard:
        return j
    d = core_accessory(j, klist)
    if post_name is None:
        return d
    from ..ops.fused_assign import apply_post

    return d, apply_post(d, (post_name, post_static, post_params))


@partial(jax.jit, static_argnames=("mesh", "klist", "sketchsize64", "bbits",
                                   "pad_bits", "random_correct", "use_rc",
                                   "jaccard", "use_pallas", "post_name",
                                   "post_static"))
def _sharded_block_jit(planes_q, planes_r, len_q, len_r, freq_q, freq_r,
                       post_params, mesh, klist, sketchsize64, bbits,
                       pad_bits, random_correct, use_rc, jaccard, use_pallas,
                       post_name=None, post_static=()):
    if jaccard or post_name is None:
        out_specs = P("q", "r", None)
    else:
        out_specs = (P("q", "r", None), P("q", "r"))
    fn = jax.shard_map(
        partial(_local_block, klist=klist, sketchsize64=sketchsize64,
                bbits=bbits, pad_bits=pad_bits, random_correct=random_correct,
                use_rc=use_rc, jaccard=jaccard, use_pallas=use_pallas,
                post_name=post_name, post_static=post_static),
        mesh=mesh,
        in_specs=(
            P("q", None, None, None), P("r", None, None, None),
            P("q"), P("r"), P("q", None), P("r", None),
            P(),  # classifier params replicated on every device
        ),
        out_specs=out_specs, check_vma=False)
    return fn(planes_q, planes_r, len_q, len_r, freq_q, freq_r, post_params)


def _fetch(x):
    """Global jax.Array -> host numpy, multi-controller safe.

    Under a multi-process mesh (jax.distributed) each process only holds
    its addressable shards; reassemble the global value with an
    allgather so every host sees the full block (the hosts' downstream
    graph/naming stages are replicated, rank 0 writes files)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _pad_axis0(arrs, n_to):
    out = []
    for a in arrs:
        pad = n_to - a.shape[0]
        if pad:
            a = np.pad(np.asarray(a), ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        out.append(a)
    return out


def sharded_pairwise_block(mesh, planes_q, planes_r, len_q, len_r, freq_q,
                           freq_r, klist, sketchsize64, bbits,
                           random_correct=True, use_rc=True, jaccard=False,
                           use_pallas=None, q_chunk=1024, post_spec=None):
    """Dense [nq, nr, 2] block, sharded over the mesh.

    Queries are processed in host-side chunks of ``q_chunk`` per q-shard to
    bound device memory for huge all-vs-all runs. With ``post_spec``
    (ops/fused_assign) returns (dists, extra[nq, nr]) — the model
    classification runs on each device's tile inside the same dispatch.
    """
    if use_pallas is None:
        use_pallas = use_kernel()
    _, _, pad_bits = plane_geometry(sketchsize64, bbits)
    post_name, post_static, post_params = post_spec or (None, (), None)
    nq, nr = planes_q.shape[0], planes_r.shape[0]
    q_size = mesh.shape["q"]
    r_size = mesh.shape["r"]

    nr_p = ((nr + r_size - 1) // r_size) * r_size
    planes_r, len_r, freq_r = _pad_axis0([planes_r, len_r, freq_r], nr_p)

    # Place reference shards once; reused across query chunks.
    planes_r = jax.device_put(
        planes_r, NamedSharding(mesh, P("r", None, None, None)))
    len_r = jax.device_put(np.asarray(len_r),
                           NamedSharding(mesh, P("r")))
    freq_r = jax.device_put(np.asarray(freq_r, dtype=np.float32),
                            NamedSharding(mesh, P("r", None)))

    step = q_chunk * q_size
    out = []
    out_extra = []
    for start in range(0, nq, step):
        stop = min(start + step, nq)
        # bucket the chunk to a power of two (then a q_size multiple) so
        # distinct batch sizes reuse O(log step) compiled programs
        bucket = 1
        while bucket < stop - start:
            bucket *= 2
        cq = ((bucket + q_size - 1) // q_size) * q_size
        pq, lq, fq = _pad_axis0(
            [planes_q[start:stop], np.asarray(len_q[start:stop]),
             np.asarray(freq_q[start:stop], dtype=np.float32)], cq)
        block = _sharded_block_jit(
            jax.device_put(pq, NamedSharding(mesh, P("q", None, None, None))),
            planes_r,
            jax.device_put(lq, NamedSharding(mesh, P("q"))),
            len_r,
            jax.device_put(fq, NamedSharding(mesh, P("q", None))),
            freq_r,
            post_params,
            mesh, tuple(int(k) for k in klist), int(sketchsize64), int(bbits),
            int(pad_bits), bool(random_correct), bool(use_rc), bool(jaccard),
            bool(use_pallas), post_name, post_static,
        )
        if post_name is not None and not jaccard:
            block, extra = block
            out_extra.append(_fetch(extra)[: stop - start, :nr])
        out.append(_fetch(block)[: stop - start, :nr])
    if post_name is not None and not jaccard:
        return (np.concatenate(out, axis=0),
                np.concatenate(out_extra, axis=0))
    return np.concatenate(out, axis=0)


def sharded_query_dists(sketches_r, sketches_q, klist, mesh,
                        random_correct=True, use_rc=True, jaccard=False,
                        use_pallas=None):
    """Long-form query-vs-ref distances, row = q * n_ref + r
    (PopPUNK/assign.py:690 row convention)."""
    from ..ops.distances import pack_planes

    ss64 = sketches_r[0].sketchsize64
    bbits = sketches_r[0].bbits
    planes_r, len_r, freq_r = pack_planes(sketches_r, klist)
    planes_q, len_q, freq_q = pack_planes(sketches_q, klist)
    block = sharded_pairwise_block(
        mesh, planes_q, planes_r, len_q, len_r, freq_q, freq_r, klist,
        ss64, bbits, random_correct, use_rc, jaccard, use_pallas)
    return block.reshape(-1, block.shape[-1])


def sharded_self_dists(sketches, klist, mesh, random_correct=True,
                       use_rc=True, jaccard=False, use_pallas=None,
                       q_chunk=1024):
    """Condensed i<j all-vs-all distances (PopPUNK/utils.py:199-226 order).

    Streams query chunks and slices each to its upper-triangle rows so the
    full n x n square is never materialised on the host."""
    from ..ops.distances import pack_planes

    ss64 = sketches[0].sketchsize64
    bbits = sketches[0].bbits
    planes, lengths, freqs = pack_planes(sketches, klist)
    n = len(sketches)
    out = []
    for start in range(0, n, q_chunk):
        stop = min(start + q_chunk, n)
        block = sharded_pairwise_block(
            mesh, planes[start:stop], planes, lengths[start:stop], lengths,
            freqs[start:stop], freqs, klist, ss64, bbits, random_correct,
            use_rc, jaccard, use_pallas, q_chunk=q_chunk)
        for local, gi in enumerate(range(start, stop)):
            out.append(block[local, gi + 1:])
    return np.concatenate(out, axis=0)
