"""Benchmark: pairwise core/accessory distance throughput per device.

The framework's hot loop (bin-match kernel + fused Jaccard
correction + per-pair k-mer curve fit — the pp-sketchlib queryDatabase
equivalent, reference PopPUNK/sketchlib.py:528-537) timed at production
sketch geometry (sketch size 9984 -> sketchsize64=156, bbits=14, 6 k-mer
lengths: the reference's bundled-dataset settings, test/run_test.py:21),
against an optimised OpenMP+popcount CPU baseline (native/cpu_baseline.cpp,
the stand-in for pp-sketchlib's CPU path). The baseline times the bin-match
counting only (no Jaccard correction / curve fit) on a 512x1024 tile, while
the device number includes the whole fused pipeline — the comparison is
conservative in the baseline's favour.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "pairs/s", "vs_baseline": N}
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np


ROOT = os.path.dirname(os.path.abspath(__file__))

KLIST = (13, 16, 19, 22, 25, 28)
SS64 = 156
BBITS = 14

# Set by --json-out PATH: every _emit() record is also appended to PATH as
# one JSON line, so the --capture orchestrator can collect full-detail
# records from subprocess runs.
JSON_OUT = None


def _emit(record):
    print(json.dumps(record))
    if JSON_OUT:
        with open(JSON_OUT, "a") as fh:
            fh.write(json.dumps(record) + "\n")


def _pinned_cpu_rate():
    """The dedicated-run CPU baseline rate pinned in BASELINE.json
    (pairs/s), or None if absent — see that file's pinned_note."""
    try:
        with open(os.path.join(ROOT, "BASELINE.json")) as fh:
            return float(json.load(fh)["pinned_cpu_pairs_per_s"])
    except Exception:  # noqa: BLE001 — unpinned is a valid state
        return None


def _build_baseline():
    from poppunk_tpu.native_build import native_lib

    return ctypes.CDLL(native_lib("cpu_baseline"))


def _synth_planes_u64(n, rng):
    """uint64 planes [n, K, P, W64] (CPU baseline layout)."""
    return rng.integers(0, 2**63, (n, len(KLIST), BBITS, SS64),
                        dtype=np.uint64)


def _u64_to_u32_planes(planes64, wp):
    """[n,K,P,W64] u64 -> [n,K,P,Wp] u32 (device layout, interleaved lo/hi)."""
    n, K, P, W = planes64.shape
    out = np.zeros((n, K, P, wp), dtype=np.uint32)
    out[..., 0:2 * W:2] = (planes64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[..., 1:2 * W:2] = (planes64 >> np.uint64(32)).astype(np.uint32)
    return out


def _device_jax():
    """jax, with the compile cache configured and an accelerator under it:
    a measurement that finds none fails instead of timing the CPU."""
    import jax

    from poppunk_tpu import configure_jax_cache

    configure_jax_cache()
    if jax.default_backend() == "cpu":
        raise SystemExit("bench.py measures the accelerator; JAX found none")
    return jax


def _device_record():
    """The device a result was measured on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def bench_cpu(lib, planes64, nq, nr, threads):
    out = np.zeros((nq, nr, len(KLIST)), dtype=np.int32)
    pq = np.ascontiguousarray(planes64[:nq])
    pr = np.ascontiguousarray(planes64[:nr])

    def run():
        lib.match_counts_cpu(
            pq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(nq), ctypes.c_int64(nr),
            ctypes.c_int64(len(KLIST)), ctypes.c_int64(BBITS),
            ctypes.c_int64(SS64),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int(threads),
        )

    run()  # warm
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    return nq * nr / dt


def bench_device(nq, nr, iters=3):
    jax = _device_jax()
    import jax.numpy as jnp

    from poppunk_tpu.ops.distances import (
        core_accessory, corrected_jaccards, plane_geometry)
    from poppunk_tpu.ops.match_kernel import match_counts

    _, wp, pad_bits = plane_geometry(SS64, BBITS)
    rng = np.random.default_rng(1)
    planes64 = _synth_planes_u64(max(nq, nr), rng)
    planes = _u64_to_u32_planes(planes64, wp)
    lengths = rng.integers(1_800_000, 2_400_000, max(nq, nr)).astype(np.int32)
    freqs = rng.dirichlet(np.ones(4), max(nq, nr)).astype(np.float32)

    @jax.jit
    def pipeline(pq, pr, lq, lr, fq, fr):
        matches = match_counts(pq, pr, pad_bits)
        j = corrected_jaccards(matches, KLIST, lq, lr, fq, fr, SS64, BBITS,
                               random_correct=True, use_rc=True)
        return core_accessory(j, KLIST)

    args = (jnp.asarray(planes[:nq]), jnp.asarray(planes[:nr]),
            jnp.asarray(lengths[:nq]), jnp.asarray(lengths[:nr]),
            jnp.asarray(freqs[:nq]), jnp.asarray(freqs[:nr]))

    jax.block_until_ready(pipeline(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(pipeline(*args))
    dt = (time.perf_counter() - t0) / iters
    return nq * nr / dt, planes64


def bench_serving(nq=256, nr=4096, iters=3):
    # the per-pair rate is size-invariant once the reference tensor is
    # resident, so genomes assigned/s at any DB size = value / n_refs.
    """Serving path: query-vs-reference distances + model classification.

    Compares the fused route (classifier inside the distance jit,
    ops/fused_assign) against the two-pass route the reference uses
    (distance matrix to host, re-upload for classification —
    PopPUNK/assign.py:502 then models.py:1085). Reference sketches stay
    device-resident, as in production serving.
    """
    jax = _device_jax()
    import jax.numpy as jnp
    from poppunk_tpu.models.refine import RefineFit
    from poppunk_tpu.ops.distances import (_dist_chunk, plane_geometry)
    from poppunk_tpu.ops.fused_assign import model_post_spec
    from poppunk_tpu.ops.match_kernel import use_kernel

    _, wp, pad_bits = plane_geometry(SS64, BBITS)
    rng = np.random.default_rng(2)
    planes64 = _synth_planes_u64(max(nq, nr), rng)
    planes = _u64_to_u32_planes(planes64, wp)
    lengths = rng.integers(1_800_000, 2_400_000, max(nq, nr)).astype(np.int32)
    freqs = rng.dirichlet(np.ones(4), max(nq, nr)).astype(np.float32)

    model = RefineFit("/tmp/bench_refine")
    model.scale = np.array([0.7, 0.9])
    model.optimal_x, model.optimal_y = 0.4, 0.6
    model.core_boundary, model.accessory_boundary = 0.4, 0.6
    model.fitted = True
    spec = model_post_spec(model)

    static = (tuple(KLIST), SS64, BBITS, pad_bits, True, True, False,
              use_kernel())
    args = (jnp.asarray(planes[:nq]), jnp.asarray(planes[:nr]),
            jnp.asarray(lengths[:nq]), jnp.asarray(lengths[:nr]),
            jnp.asarray(freqs[:nq]), jnp.asarray(freqs[:nr]))

    def fused():
        # serving delivers only the per-pair classification to the host;
        # the distance tile lives and dies on device
        _, a = _dist_chunk(*args, *static, *spec)
        return np.asarray(a)

    def two_pass():
        # the reference route: full distance matrix to the host, classify
        # there (PopPUNK/models.py:1085 runs on the host matrix)
        d = np.asarray(_dist_chunk(*args, *static))
        return model.assign(d.reshape(-1, 2))

    out = {}
    for name, fn in (("fused", fused), ("two_pass", two_pass)):
        fn()  # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters
        out[name] = nq * nr / dt
        sys.stderr.write(f"serving {name}: {out[name] / 1e6:.1f} Mpairs "
                         f"classified/s = {out[name] / nr:.0f} genomes "
                         f"assigned/s ({nq} queries x {nr} refs)\n")
    _emit({
        "metric": "serving: query dists + model classification "
                  f"({nq} queries x {nr} device-resident refs); "
                  "genomes_assigned_per_s = value / n_refs",
        "value": round(out["fused"], 1),
        "unit": "pairs/s",
        "vs_baseline": round(out["fused"] / out["two_pass"], 2),
        "fused_pairs_per_s": round(out["fused"], 1),
        "two_pass_pairs_per_s": round(out["two_pass"], 1),
        "device": _device_record(),
    })


def bench_serving_prod(nq=2048, nr=20480, iters=3, n_strains=64):
    """Production assign metric: genomes assigned/s against a ~20k-genome
    DEVICE-RESIDENT reference set at production sketch geometry
    (BASELINE.md "Scaling curve" row; reference hot path
    PopPUNK/assign.py:502 + models.py:1085).

    The reference sketches are synthesised ON DEVICE
    (synth.synthetic_population_device), so the one-time DB load is not
    part of the number. Steady-state serving is what this measures:
    per query batch, distances + boundary classification fused in one
    dispatch, then device-side compaction of the within-strain (query,
    ref) edge list — the O(E) output the network attach actually needs —
    fetched to the host, where each query is joined to its neighbours'
    cluster (the batch-mode attach of assign.py:576-661). Fetching the
    raw |Q|x|R| sign matrix instead would be O(Q.R) host traffic; that
    is the two-pass route bench_serving already measures.
    """
    jax = _device_jax()
    import jax.numpy as jnp
    from poppunk_tpu.models.refine import RefineFit
    from poppunk_tpu.ops.distances import (
        core_accessory, corrected_jaccards, plane_geometry)
    from poppunk_tpu.ops.fused_assign import apply_post, model_post_spec
    from poppunk_tpu.ops.match_kernel import match_counts
    from poppunk_tpu.synth import synthetic_population_device

    # the separable-strain geometry the >20480 scale tiers plant
    # (scale.py run_scale_pipeline synth_kwargs rationale): PopPUNK's
    # model presumes a bimodal within/between structure
    pop = synthetic_population_device(
        nr + nq, KLIST, SS64, BBITS, n_strains=n_strains, seed=3,
        chunk=2048, strain_div=(0.015, 0.03),
        accessory_strain=(0.55, 0.75))
    jax.block_until_ready(pop.planes)
    _, _, pad_bits = plane_geometry(SS64, BBITS)

    # synth orders genomes by strain — a contiguous query slice would all
    # come from one strain. Take a strided sample as queries (every
    # (n/nq)-th genome) and the complement as the reference set, so
    # queries span the strains like a real assignment batch.
    n_all = nr + nq
    qidx = np.arange(nq) * (n_all // nq)
    mask = np.ones(n_all, bool)
    mask[qidx] = False
    ridx = np.flatnonzero(mask)
    order = jnp.asarray(np.concatenate([ridx, qidx]))
    planes_all = jnp.take(pop.planes, order, axis=2)
    lengths_all = jnp.take(pop.lengths, order, axis=0)
    freqs_all = jnp.take(pop.freqs, order, axis=0)
    strain_all = np.asarray(pop.strain)[np.asarray(order)]
    del pop
    jax.block_until_ready(planes_all)

    def small_block(planes, lengths, freqs, sidx):
        p = jnp.take(planes, sidx, axis=2)
        m = match_counts(p, p, pad_bits, plane_major=True)
        j = corrected_jaccards(m, KLIST, lengths[sidx], lengths[sidx],
                               freqs[sidx], freqs[sidx], SS64, BBITS,
                               random_correct=True, use_rc=True)
        return core_accessory(j, KLIST)

    # place the boundary empirically between the planted within/between
    # blobs (a sampled ns x ns block, one small dispatch) so the attach
    # agreement check below is meaningful. STRIDE the sample across the
    # reference set: refs stay strain-ordered after the query reorder, so
    # a contiguous [0, ns) block can be a single strain (empty `diff`)
    ns = min(512, nr)
    # (i * nr) // ns spreads over the WHOLE reference range for any
    # nr >= ns (a plain integer stride degenerates to a contiguous —
    # possibly single-strain — block whenever ns <= nr < 2*ns)
    sidx = (np.arange(ns) * nr) // ns
    d_small = np.asarray(jax.jit(small_block)(
        planes_all, lengths_all, freqs_all,
        jnp.asarray(sidx))).reshape(ns, ns, 2)
    s_small = strain_all[sidx]
    same = (s_small[:, None] == s_small[None, :]) & ~np.eye(ns, dtype=bool)
    diff = ~(s_small[:, None] == s_small[None, :])
    # pick the boundary rule (slope 0 = core only, 1 = accessory only,
    # 2 = diagonal) with the widest relative within/between margin on
    # the sampled block, then place it mid-margin
    def margin(stat):
        w_max, b_min = stat[same].max(), stat[diff].min()
        rel = (b_min - w_max) / max(b_min, 1e-9)
        return rel, (w_max + b_min) / 2

    mx, bx1 = margin(d_small[..., 0])
    my, by1 = margin(d_small[..., 1])
    bx0 = (d_small[..., 0][same].max() + d_small[..., 0][diff].min()) / 2
    by0 = (d_small[..., 1][same].max() + d_small[..., 1][diff].min()) / 2
    t = d_small[..., 0] / max(bx0, 1e-9) + d_small[..., 1] / max(by0, 1e-9)
    md, fd = margin(t)
    model = RefineFit("/tmp/bench_refine")
    model.scale = np.array([1.0, 1.0])
    best = max((mx, 0), (my, 1), (md, 2))
    if best[1] == 0:
        model.slope, bx, by = 0, bx1, 0.0
    elif best[1] == 1:
        model.slope, bx, by = 1, 0.0, by1
    else:
        model.slope, bx, by = 2, fd * bx0, fd * by0
    sys.stderr.write(f"boundary: slope {model.slope}, margins "
                     f"core {mx:.3f} acc {my:.3f} diag {md:.3f}\n")
    model.optimal_x, model.optimal_y = float(bx), float(by)
    model.core_boundary, model.accessory_boundary = float(bx), float(by)
    model.fitted = True
    spec = model_post_spec(model)

    # within pairs per query ~ |query's strain| ~ nr/n_strains on average
    # (dirichlet sizes make some strains larger); 4x headroom
    cap = int(4 * nq * max(nr // max(n_strains, 1), 1))

    @jax.jit
    def assign_batch(planes, lengths, freqs, params):
        pq = jax.lax.slice_in_dim(planes, nr, nr + nq, axis=2)
        pr = jax.lax.slice_in_dim(planes, 0, nr, axis=2)
        m = match_counts(pq, pr, pad_bits, plane_major=True)
        j = corrected_jaccards(m, KLIST, lengths[nr:], lengths[:nr],
                               freqs[nr:], freqs[:nr], SS64, BBITS,
                               random_correct=True, use_rc=True)
        d = core_accessory(j, KLIST)
        sign = apply_post(d, (spec[0], spec[1], params)).reshape(nq, nr)
        within = (sign == -1).ravel()
        pos = jnp.nonzero(within, size=cap, fill_value=-1)[0]
        return pos.astype(jnp.int32), within.sum(dtype=jnp.int32)

    args = (planes_all, lengths_all, freqs_all, spec[2])
    ref_cluster = strain_all[:nr]

    def attach(pos_d, n_within_d):
        pos = np.asarray(pos_d)  # O(E) edge fetch — the production output
        n_within = int(np.asarray(n_within_d))
        pos = pos[pos >= 0]
        q, r = pos // nr, pos % nr
        # batch attach: each query joins its neighbours' component;
        # queries with no within-edge found a novel cluster (-1)
        sentinel = np.iinfo(np.int64).max
        clusters = np.full(nq, sentinel, np.int64)
        np.minimum.at(clusters, q, ref_cluster[r])
        clusters[clusters == sentinel] = -1
        return n_within, clusters

    def full_assign():
        return attach(*assign_batch(*args))

    n_within, clusters = full_assign()  # compile + warm
    assert n_within <= cap, f"{n_within} within pairs > cap {cap}"
    # sanity: the boundary was placed between the planted blobs, so the
    # attach must agree with each query's planted strain
    truth = strain_all[nr:]
    agree = float((clusters == truth).mean())
    sys.stderr.write(f"attach agreement vs planted strains: "
                     f"{agree:.3f} ({n_within} within pairs)\n")
    t0 = time.perf_counter()
    for _ in range(iters):
        full_assign()
    dt_serial = (time.perf_counter() - t0) / iters

    # double-buffered steady state (serve.AssignSession.assign_sketches
    # discipline): batch i+1's device dispatch queues BEFORE batch i's
    # fetch + host attach, so the attach rides under device compute
    pend = assign_batch(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        nxt = assign_batch(*args)
        attach(*pend)
        pend = nxt
    dt = (time.perf_counter() - t0) / iters
    attach(*pend)

    # device-only rate (no edge fetch) isolates the host transfer
    jax.block_until_ready(assign_batch(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(assign_batch(*args))
    dt_dev = (time.perf_counter() - t0) / iters

    g_per_s = nq / dt
    sys.stderr.write(
        f"assign: {nq} queries x {nr} device-resident refs in {dt:.2f}s "
        f"= {g_per_s:.0f} genomes/s double-buffered "
        f"({nq * nr / dt / 1e6:.1f} Mpairs/s incl. edge fetch; "
        f"serial {nq / dt_serial:.0f}, "
        f"device-only {nq / dt_dev:.0f} genomes/s)\n")
    _emit({
        "metric": f"production assign: genomes assigned/s vs {nr} "
                  "device-resident refs (fused dists + boundary "
                  "classification + device edge compaction + "
                  "double-buffered host attach)",
        "value": round(g_per_s, 1),
        "unit": "genomes/s",
        "vs_baseline": None,
        "n_refs": nr,
        "n_queries_per_batch": nq,
        "pairs_per_s": round(nq * nr / dt, 1),
        "genomes_per_s_serial": round(nq / dt_serial, 1),
        "genomes_per_s_device_only": round(nq / dt_dev, 1),
        "within_pairs_per_batch": int(n_within),
        "attach_agreement": round(agree, 4),
        "device": _device_record(),
    })


def _gen_sketch_bench_inputs(n_fasta=16, n_fastq=8, glen=2_000_000,
                             coverage=10, read_len=150):
    """Synthetic FASTA assemblies (~2 Mbp, realistic bacterial size,
    docs/sketching.rst:73-81 geometry) and FASTQ read sets for the
    sketching benchmark. Cached in /tmp across runs.

    n_fastq must comfortably exceed the core count: a 3-read-set
    fixture under-filled the 4-process pool and the pooled genomes/s
    number measured pool latency, not throughput."""
    d = "/tmp/poppunk_sketch_bench"
    marker = os.path.join(d, ".done_v2")
    fastas = [os.path.join(d, f"asm{i}.fa") for i in range(n_fasta)]
    fastqs = [os.path.join(d, f"reads{i}.fastq") for i in range(n_fastq)]
    if not os.path.isfile(marker):
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(7)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        for i, path in enumerate(fastas):
            g = bases[rng.integers(0, 4, glen)]
            lines = [g[s:s + 80].tobytes() for s in range(0, glen, 80)]
            with open(path, "wb") as fh:
                fh.write(b">asm%d\n" % i)
                fh.write(b"\n".join(lines) + b"\n")
        n_reads = glen * coverage // read_len
        qual = b"I" * read_len
        for i, path in enumerate(fastqs):
            g = bases[rng.integers(0, 4, glen)]
            starts = rng.integers(0, glen - read_len, n_reads)
            with open(path, "wb") as fh:
                for j, s in enumerate(starts):
                    fh.write(b"@r%d\n" % j)
                    fh.write(g[s:s + read_len].tobytes())
                    fh.write(b"\n+\n")
                    fh.write(qual)
                    fh.write(b"\n")
        with open(marker, "w") as fh:
            fh.write("ok")
    return fastas, fastqs


def bench_sketch():
    """Host sketching throughput: genomes/s for FASTA assemblies and
    FASTQ read sets, single process (OpenMP across k-mer lengths) vs the
    construct_database process pool (reference constructDatabase,
    PopPUNK/sketchlib.py:348-434 — the stage that dominates create-db
    wall clock at 20k-100k genomes, docs/sketching.rst:73-81)."""
    import shutil

    from poppunk_tpu.io.hdf5db import construct_database
    from poppunk_tpu.sketch.minhash import SketchParams, sketch_codes
    from poppunk_tpu.sketch.reader import read_sequence_input

    ncpu = os.cpu_count() or 1
    fastas, fastqs = _gen_sketch_bench_inputs()
    params = SketchParams(klist=KLIST, sketchsize64=SS64, use_rc=True)
    out = {}

    # single-core kernel rate (parse excluded): one genome, threads=1
    codes, _, _, _ = read_sequence_input([fastas[0]])
    sketch_codes(codes, params, native_threads=1)  # warm (lib build)
    t0 = time.perf_counter()
    sketch_codes(codes, params, native_threads=1)
    out["fasta_1core_kernel"] = 1 / (time.perf_counter() - t0)

    db = "/tmp/poppunk_sketch_bench/db"
    names = [f"asm{i}" for i in range(len(fastas))]
    seqs = [[p] for p in fastas]
    for label, threads in (("fasta_1proc", 1), (f"fasta_{ncpu}proc", ncpu)):
        shutil.rmtree(db, ignore_errors=True)
        t0 = time.perf_counter()
        construct_database(None, KLIST, SS64, db, threads=threads,
                           calc_random=False, names=names, sequences=seqs)
        out[label] = len(fastas) / (time.perf_counter() - t0)

    qnames = [f"reads{i}" for i in range(len(fastqs))]
    qseqs = [[p] for p in fastqs]
    for label, threads in (("fastq_1proc", 1), (f"fastq_{ncpu}proc", ncpu)):
        shutil.rmtree(db, ignore_errors=True)
        t0 = time.perf_counter()
        construct_database(None, KLIST, SS64, db, threads=threads,
                           calc_random=False, min_count=2,
                           names=qnames, sequences=qseqs)
        out[label] = len(fastqs) / (time.perf_counter() - t0)
    # --exact-count mode: the candidate-verified exact filter (no
    # count-min table at all — one bin-minimum lookup per hash, count
    # map touched only on candidate occurrences). Exact multiplicity
    # semantics (reference flag, PopPUNK --exact-count); differs from
    # the count-min default only in the latter's collision
    # false-positives.
    for label, threads in (("fastq_exact_1proc", 1),
                           (f"fastq_exact_{ncpu}proc", ncpu)):
        shutil.rmtree(db, ignore_errors=True)
        t0 = time.perf_counter()
        construct_database(None, KLIST, SS64, db, threads=threads,
                           calc_random=False, min_count=2, use_exact=True,
                           names=qnames, sequences=qseqs)
        out[label] = len(fastqs) / (time.perf_counter() - t0)
    shutil.rmtree(db, ignore_errors=True)

    for k, v in out.items():
        sys.stderr.write(f"sketch {k}: {v:.2f} genomes/s\n")
    pooled = out[f"fasta_{ncpu}proc"]
    _emit({
        "metric": f"host sketching: FASTA genomes/s, {ncpu}-process pool "
                  "(2 Mbp assemblies, production sketch geometry); "
                  "detail keys: 1-core kernel, 1-proc (OpenMP over k), "
                  "N-proc pools, FASTQ 10x-coverage reads min_count=2",
        "value": round(pooled, 2),
        "unit": "genomes/s",
        "vs_baseline": round(pooled / out["fasta_1proc"], 2),
        "detail": {k: round(v, 3) for k, v in out.items()},
        "n_cores": ncpu,
    })


def bench_capture():
    """Run every headline benchmark in its own subprocess and merge the
    full-detail records into BENCH_scale.json — the committed, auditable
    artefact for the scale/serve/sketch figures. Subprocesses isolate
    device-memory footprints and let a hung entry die alone, not the
    whole capture; the artefact is rewritten after every entry so partial
    progress persists."""
    import datetime

    entries = [
        ("kernel", [], 1200),
        ("sketch", ["--sketch"], 2400),
        ("refine_corners_100k", ["--refine-corners"], 2400),
        ("serve_4k", ["--serve"], 1200),
        ("serve_prod_20k", ["--serve-prod"], 2400),
        ("scale_20480", ["--scale", "20480"], 2400),
        ("scale_65536", ["--scale", "65536"], 4800),
        ("scale_81920", ["--scale", "81920"], 7200),
        ("colshard_8192", ["--colshard", "8192"], 4800),
        ("validate_24576", ["--validate", "24576"], 4800),
        ("brandes_ab", ["--brandes-ab"], 2400),
    ]
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    out_path = os.path.join(ROOT, "BENCH_scale.json")
    merged = {}
    if os.path.isfile(out_path):
        with open(out_path) as fh:
            merged = json.load(fh)
    merged.setdefault("meta", {})
    for name, flags, tmo in entries:
        if only and name not in only:
            continue
        tmp = f"/tmp/bench_capture_{name}.json"
        if os.path.isfile(tmp):
            os.remove(tmp)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "bench.py"), *flags,
                 "--json-out", tmp],
                timeout=tmo, cwd=ROOT)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        wall = time.perf_counter() - t0
        rec = {"rc": rc, "wall_s": round(wall, 1)}
        if os.path.isfile(tmp):
            with open(tmp) as fh:
                lines = [json.loads(ln) for ln in fh if ln.strip()]
            if lines:
                rec.update(lines[-1])
        # a failed retry must not replace a committed clean record
        old = merged.get(name)
        if rc != 0 and old is not None and old.get("rc") == 0:
            sys.stderr.write(f"capture {name}: keeping previous record "
                             f"(new run failed: rc={rc})\n")
            continue
        merged[name] = rec
        merged["meta"]["captured"] = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
        with open(out_path, "w") as fh:
            json.dump(merged, fh, indent=1)
            fh.write("\n")
        sys.stderr.write(f"capture {name}: rc={rc} {wall:.0f}s\n")
    print(json.dumps({"metric": "capture", "value": len(merged) - 1,
                      "unit": "entries", "vs_baseline": None}))


def bench_refine_corners(n=100_000, n_strains=100, grid=20,
                         within_deg=40, n_between=200_000):
    """Host-only timings for the two refine corners unmeasured at 100k:
    the 20x20 unconstrained 2-D grid scored at
    every score_idx through the native engine (the reference pool-
    parallelises exactly this, PopPUNK/refine.py:147-166), and full-
    clique --extract-references on a 100k-vertex network
    (PopPUNK/network.py:409-423).

    Geometry mirrors a fitted 100k population: n_strains clusters whose
    within edges (avg degree `within_deg`) carry small scaled distances,
    plus `n_between` between-strain pairs near the grid edge — the same
    O(E) in-union set refine_fit_device_2d fetches (its per-cell
    membership is host arithmetic over this set; this bench times the
    scoring loop it runs, row by row)."""
    import tempfile

    from poppunk_tpu.network.cliques import extract_references
    from poppunk_tpu.network.graph import Graph
    from poppunk_tpu.network.incremental import grow_network_scores

    rng = np.random.default_rng(11)
    per = n // n_strains
    base = np.arange(n_strains)[:, None] * per
    # within-strain edges: random pairs inside each strain block
    m_within = n * within_deg // 2
    a = rng.integers(0, per, (n_strains, m_within // n_strains))
    b = rng.integers(0, per, (n_strains, m_within // n_strains))
    keep = a != b
    iw = (base + np.minimum(a, b))[keep]
    jw = (base + np.maximum(a, b))[keep]
    # dedupe (multigraph edges would distort transitivity)
    key = iw.astype(np.int64) * n + jw
    _, uniq = np.unique(key, return_index=True)
    iw, jw = iw[uniq], jw[uniq]
    xw = rng.uniform(0.05, 0.35, iw.shape[0]).astype(np.float32)
    yw = rng.uniform(0.05, 0.35, iw.shape[0]).astype(np.float32)
    # between-strain pairs sit near the grid edge (captured only by the
    # widest cells, like real between-strain blobs past the optimum)
    ib = rng.integers(0, n, n_between)
    jb = rng.integers(0, n, n_between)
    ok = ib // per != jb // per
    ib, jb = ib[ok], jb[ok]
    xb = rng.uniform(0.85, 1.0, ib.shape[0]).astype(np.float32)
    yb = rng.uniform(0.85, 1.0, ib.shape[0]).astype(np.float32)
    i_all = np.concatenate([iw, ib]).astype(np.int64)
    j_all = np.concatenate([jw, jb]).astype(np.int64)
    xs = np.concatenate([xw, xb]).astype(np.float64)
    ys = np.concatenate([yw, yb]).astype(np.float64)
    E = i_all.shape[0]
    sys.stderr.write(f"refine-corners: {n} vertices, {E} fetched pairs "
                     f"({iw.shape[0]} within / {ib.shape[0]} between)\n")

    x_max = np.linspace(0.3, 1.01, grid)
    y_max = np.linspace(0.3, 1.01, grid)
    out = {}
    for score_idx in (0, 1, 2):
        srng = np.random.default_rng(42)
        t0 = time.perf_counter()
        global_s = np.ones((grid, grid))
        for r in range(grid):
            ym = float(y_max[r])
            with np.errstate(divide="ignore", invalid="ignore"):
                t = np.where(ys < ym, xs * ym / (ym - ys), np.inf)
            idx = np.searchsorted(x_max, t, side="left").astype(np.int32)
            keep = idx < grid
            global_s[r] = grow_network_scores(
                n, i_all[keep], j_all[keep], idx[keep], grid,
                score_idx, 100, rng=srng)
        out[f"grid2d_idx{score_idx}_s"] = time.perf_counter() - t0
        sys.stderr.write(
            f"2-D {grid}x{grid} grid, score_idx {score_idx}: "
            f"{out[f'grid2d_idx{score_idx}_s']:.1f}s "
            f"(best {global_s.min():.4f})\n")

    # full-clique reference extraction on the within-strain network
    G = Graph(n, np.stack([iw, jw], axis=1))
    names = [f"g{v}" for v in range(n)]
    with tempfile.TemporaryDirectory() as td:
        for label, fast in (("clique_full", False), ("clique_fast", True)):
            t0 = time.perf_counter()
            refs, _, _, _ = extract_references(
                G, names, os.path.join(td, label), fast_mode=fast,
                rng=np.random.default_rng(1))
            out[f"{label}_s"] = time.perf_counter() - t0
            out[f"{label}_refs"] = len(refs)
            sys.stderr.write(
                f"extract-references {label}: "
                f"{out[f'{label}_s']:.1f}s -> {len(refs)} refs\n")

    _emit({
        "metric": f"refine corners at {n} vertices / {E} pairs: 2-D "
                  f"{grid}x{grid} grid per score_idx + full-clique vs "
                  "fast reference extraction (host+native engine)",
        "value": round(out["grid2d_idx2_s"], 1),
        "unit": "s",
        "vs_baseline": None,
        "detail": {k: (round(v, 2) if isinstance(v, float) else v)
                   for k, v in out.items()},
        "n_vertices": n, "n_pairs_fetched": int(E),
    })


def bench_colshard(n=16384):
    """Column-sharded (shard_planes) streaming tier on the device.

    The 128k+ story splits the planes over the genome axis. Here a
    1-device mesh forces the column-sharded kernels onto the device at a
    size that also fits replicated, and every consumer (fused
    kNN, sweep counts, sweep fetch) is asserted equal to the replicated
    single-device path on-chip.
    """
    jax = _device_jax()
    import jax.numpy as jnp
    from poppunk_tpu.scale import (StreamingCondensed, sweep_counts_streaming,
                                   sweep_first_offsets)
    from poppunk_tpu.synth import synthetic_population_device

    mesh = jax.make_mesh((1, 1), ("q", "r"))
    pop = synthetic_population_device(
        n, KLIST, SS64, BBITS, n_strains=max(4, n // 640), seed=5,
        chunk=min(2048, n // 4), strain_div=(0.015, 0.03),
        accessory_strain=(0.55, 0.75))
    jax.block_until_ready(pop.planes)

    kw = dict(chunk=min(512, n // 4), knn=5)
    t0 = time.perf_counter()
    col = StreamingCondensed(pop.planes, pop.lengths, pop.freqs, KLIST,
                             SS64, BBITS, mesh=mesh, shard_planes=True,
                             **kw)
    jax.block_until_ready(col.knn_dist)
    t_col = time.perf_counter() - t0
    assert col._col, "shard_planes did not engage"

    t0 = time.perf_counter()
    rep = StreamingCondensed(pop.planes, pop.lengths, pop.freqs, KLIST,
                             SS64, BBITS, **kw)
    jax.block_until_ready(rep.knn_dist)
    t_rep = time.perf_counter() - t0

    # fused kNN equality (indices exact up to float near-ties: compare
    # distances, then indices where the distance gap is decisive)
    kd_c, kd_r = np.asarray(col.knn_dist), np.asarray(rep.knn_dist)
    np.testing.assert_allclose(kd_c, kd_r, rtol=5e-4, atol=5e-5)

    scale = rep.max_scale()
    np.testing.assert_allclose(col.max_scale(), scale, rtol=1e-6)
    offsets = np.linspace(0.0, 0.35, 20)
    line = (0.05, 0.05, 0.6, 0.6)
    t0 = time.perf_counter()
    cum_c = sweep_counts_streaming(col, scale, offsets, 2, *line)
    t_counts = time.perf_counter() - t0
    cum_r = sweep_counts_streaming(rep, scale, offsets, 2, *line)
    np.testing.assert_array_equal(cum_c, cum_r)

    ic, jc, xc, dc = sweep_first_offsets(col, scale, offsets, 2, *line)
    ir, jr, xr, dr = sweep_first_offsets(rep, scale, offsets, 2, *line)
    # column-sharded fetch returns a different (valid) pair permutation
    oc = np.lexsort((jc, ic))
    orp = np.lexsort((jr, ir))
    np.testing.assert_array_equal(ic[oc], ir[orp])
    np.testing.assert_array_equal(jc[oc], jr[orp])
    np.testing.assert_array_equal(xc[oc], xr[orp])

    # the MESH-sharded device sparse sweep on the device: per-device
    # fill shards all-gathered on device, scored on
    # device, equality-pinned to the single-device sweep — no O(E) host
    # fetch on either path
    from poppunk_tpu.ops.sparse_sweep import sweep_scores_sparse_device
    from poppunk_tpu.scale import (_line_d0_params, sweep_counts_mesh,
                                   sweep_fill_device)

    _, _, t_grid = _line_d0_params(offsets, 2, *line)
    cum_g, per_dev = sweep_counts_mesh(col, scale, offsets, 2, *line)
    np.testing.assert_array_equal(cum_g, cum_r)
    t0 = time.perf_counter()
    edges_c, cum_fill = sweep_fill_device(
        col, scale, offsets, 2, *line, n_act=len(offsets),
        e_total=int(cum_g[-1]), e_per_dev=per_dev[:, -1])
    t_fill_mesh = time.perf_counter() - t0
    np.testing.assert_array_equal(cum_fill, cum_r)
    t0 = time.perf_counter()
    sc_mesh, _ = sweep_scores_sparse_device(edges_c, t_grid)
    t_score_mesh = time.perf_counter() - t0
    edges_c = None  # free the mesh edge buffers before the twin's
    edges_r, _ = sweep_fill_device(rep, scale, offsets, 2, *line,
                                   n_act=len(offsets),
                                   e_total=int(cum_r[-1]))
    sc_rep, _ = sweep_scores_sparse_device(edges_r, t_grid)
    np.testing.assert_allclose(sc_mesh, sc_rep, rtol=1e-5, atol=1e-6)

    pairs = n * (n - 1) / 2
    sys.stderr.write(
        f"colshard: n={n} on {jax.devices()[0].platform}: dists+kNN "
        f"col {t_col:.1f}s vs replicated {t_rep:.1f}s; counts pass "
        f"{t_counts:.1f}s; kNN/counts/fetch equal; mesh sparse sweep "
        f"fill {t_fill_mesh:.1f}s + score {t_score_mesh:.1f}s over "
        f"{int(cum_r[-1])} edges, scores == single-device\n")
    _emit({
        "metric": f"column-sharded (shard_planes) streaming tier on the "
                  f"device at n={n}: dists+fused-kNN pairs/s, "
                  "equality-pinned to the replicated path on-device; "
                  "incl. mesh-sharded device sparse sweep",
        "value": round(pairs / t_col, 1),
        "unit": "pairs/s",
        "vs_baseline": round(t_rep / t_col, 3),
        "n": n,
        "col_dists_s": round(t_col, 1),
        "replicated_dists_s": round(t_rep, 1),
        "counts_pass_s": round(t_counts, 1),
        "mesh_sweep_fill_s": round(t_fill_mesh, 1),
        "mesh_sweep_score_s": round(t_score_mesh, 1),
        "mesh_sweep_edges": int(cum_r[-1]),
        "device": _device_record(),
    })


def bench_scale(n=20480):
    """End-to-end pipeline at realistic N, everything device-resident.

    synth sketches -> condensed dists + fused lineage kNN -> BGMM on a
    100k-pair subsample -> refine boundary (device sweep + native sparse
    scorer) -> network -> clusters, with per-stage wall clock. Asserts the
    host never holds an O(n^2) allocation (the condensed matrix at n=20480
    is 1.7 GB; peak-RSS growth must stay an order below it).
    """
    import resource

    jax = _device_jax()
    from poppunk_tpu.scale import run_scale_pipeline

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on Linux
    out = run_scale_pipeline(n=n, chunk=512)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    grown_mb = (rss1 - rss0) / 1024
    # O(E) fetches (in-boundary sweep pairs, final network edges) are
    # legitimate and grow ~n^2/n_strains; the assert guards against
    # O(n^2) allocations, so the bar is an order below the condensed
    # matrix with an 800 MiB floor for small tiers
    limit_mb = max(800, out["n_pairs"] * 8 / 2**20 / 4)
    sys.stderr.write(f"peak host RSS growth {grown_mb:.0f} MiB "
                     f"(limit {limit_mb}; condensed would be "
                     f"{out['n_pairs'] * 8 / 2**20:.0f} MiB)\n")
    assert grown_mb < limit_mb, \
        f"host RSS grew {grown_mb:.0f} MiB — an O(n^2) host allocation?"

    try:
        lib = _build_baseline()
        rng = np.random.default_rng(1)
        planes64 = _synth_planes_u64(1024, rng)
        cpu_rate = bench_cpu(lib, planes64, 512, 1024, os.cpu_count() or 1)
    except Exception as e:  # noqa: BLE001
        sys.stderr.write(f"cpu baseline failed: {e}\n")
        cpu_rate = float("nan")

    stages = ", ".join(f"{k} {v:.1f}s" for k, v in out["timings"].items())
    sys.stderr.write(f"stages: {stages}\n")
    _emit({
        "metric": f"end-to-end {n}-genome pipeline, device-resident "
                  "(dists+kNN -> BGMM -> refine -> network; ARI "
                  f"{out['ari']:.3f} vs planted strains, "
                  f"pipeline {out['pipeline_s']:.1f}s)",
        "value": round(out["pairs_per_s"], 1),
        "unit": "pairs/s",
        "vs_baseline": round(
            out["pairs_per_s"] / (_pinned_cpu_rate() or cpu_rate), 2)
        if (_pinned_cpu_rate() or cpu_rate == cpu_rate) else None,
        "n": n,
        "n_pairs": out["n_pairs"],
        "ari": round(float(out["ari"]), 4),
        "n_clusters": out.get("n_clusters"),
        "pipeline_s": round(out["pipeline_s"], 1),
        "stage_s": {k: round(v, 1) for k, v in out["timings"].items()},
        "refine_phase_s": out.get("refine_phase_s"),
        "streaming": out.get("streaming"),
        "peak_rss_growth_mib": round(grown_mb, 1),
        "rss_limit_mib": round(limit_mb, 1),
        "device": _device_record(),
    })


def bench_validate(n=24576):
    """Streaming/device refine vs the host full-fidelity path AT SCALE,
    on an adversarial population.

    One population, one model fit, two independent refine engines:
    - host path: buffered folded CondensedDevice, O(E) host pair fetch,
      native incremental scorer + host union-find components
      (POPPUNK_TPU_SPARSE_SWEEP=0 — the full-fidelity engine whose
      semantics mirror PopPUNK/refine.py:375-474)
    - device path: StreamingCondensed two-round bootstrap, device
      sparse sweep scoring, device label-prop components

    The population plants HEAVY strain-size imbalance (strain_alpha
    0.3: a few dominant clones + a singleton tail) — exactly the
    geometry the planted-ARI fixtures don't cover. Asserts the two
    engines produce IDENTICAL cluster partitions at the same boundary
    (the streamed distances are bit-identical to the buffered ones by
    construction, so any mismatch is an enumeration/scoring bug), and
    near-equal boundaries (local-step policies differ: Brent vs flat
    micro-grid — bounded by one global grid step)."""
    jax = _device_jax()
    from poppunk_tpu.models.bgmm import BGMMFit
    from poppunk_tpu.network.incremental import components_native
    from poppunk_tpu.scale import (StreamingCondensed, edge_components_device,
                                   fill_condensed_device, offset_threshold,
                                   plan_sweep_band, refine_fit_device,
                                   sweep_fill_device)
    from poppunk_tpu.synth import synthetic_population_device
    from poppunk_tpu.utils import adjusted_rand_index as adjusted_rand_score

    t_all0 = time.time()
    pop = synthetic_population_device(
        n, KLIST, SS64, BBITS, n_strains=max(12, n // 512), seed=5,
        chunk=2048, strain_div=(0.015, 0.03),
        accessory_strain=(0.55, 0.75), strain_alpha=0.3)
    jax.block_until_ready(pop.planes)
    sizes = np.bincount(pop.strain)
    sys.stderr.write(
        f"validate: {n} genomes, {len(sizes)} strains, sizes "
        f"min/median/max {sizes.min()}/{int(np.median(sizes))}/"
        f"{sizes.max()} (heavy imbalance)\n")

    # ONE model fit feeds both engines (same scale, same line)
    sub_n = 5 * n
    sc = StreamingCondensed(pop.planes, pop.lengths, pop.freqs, KLIST,
                            SS64, BBITS, chunk=128, knn=5, defer=True)
    sub = sc.subsample_pairs(sub_n, seed=5, block=32768)
    model = BGMMFit("", max_samples=sub_n)
    model.fit(sub, max_components=2)
    mean0 = model.means[model.within_label]
    mean1 = model.means[model.between_label]
    results = {}

    # device path: bootstrap fill fused into pass 1, sparse-sweep score
    t0 = time.time()
    spec = plan_sweep_band(sc, model.scale, mean0, mean1, max_move=0.25,
                           est_pairs=sub)
    sc.run_pass1(spec)
    dx, dy, ds, dsweep = refine_fit_device(
        sc, model.scale, mean0, mean1, max_move=0.25, score_idx=0,
        seed=5, prefill=sc.pop_prefill(), est_pairs=sub)
    assert dsweep[0] == "edges", dsweep[0]
    _, d_edges, s_range, line = dsweep
    t_dev = offset_threshold(ds, s_range, 2, *line)
    labels_dev, k_dev = edge_components_device(d_edges, t_dev)
    results["device_s"] = time.time() - t0

    # host path: buffered tier, O(E) fetch + native scorer
    t0 = time.time()
    os.environ["POPPUNK_TPU_SPARSE_SWEEP"] = "0"
    try:
        cd = fill_condensed_device(pop.planes, pop.lengths, pop.freqs,
                                   KLIST, SS64, BBITS, chunk=256, knn=5)
        jax.block_until_ready(cd.buf)
        hx, hy, hs, hsweep = refine_fit_device(
            cd, model.scale, mean0, mean1, max_move=0.25, score_idx=0,
            seed=5)
        assert hsweep[0] == "sparse", hsweep[0]
        _, hi, hj, hidx, hd0, s_range_h, line_h = hsweep
        t_host = offset_threshold(hs, s_range_h, 2, *line_h)
        mask = hd0 <= t_host
        labels_host = components_native(n, hi[mask], hj[mask])[0]
        k_host = int(mask.sum())
    finally:
        os.environ.pop("POPPUNK_TPU_SPARSE_SWEEP", None)
    results["host_s"] = time.time() - t0

    # the two engines' local policies differ (Brent vs micro-grid):
    # boundaries agree within one global grid step
    step = float(s_range[1] - s_range[0])
    assert abs(hs - ds) <= step, (hs, ds, step)
    results["boundary_dev"] = [float(dx * model.scale[0]),
                               float(dy * model.scale[1])]
    results["boundary_host"] = [float(hx * model.scale[0]),
                                float(hy * model.scale[1])]

    # partitions at each engine's OWN boundary
    ari_cross = adjusted_rand_score(labels_host, labels_dev)
    # device components AT THE HOST BOUNDARY: must be identical
    labels_dev_at_h, k_dev_at_h = edge_components_device(d_edges,
                                                         float(t_host))
    ari_same_t = adjusted_rand_score(labels_host, labels_dev_at_h)
    assert k_dev_at_h == k_host, (k_dev_at_h, k_host)
    assert ari_same_t == 1.0, ari_same_t
    ari_planted_dev = adjusted_rand_score(pop.strain, labels_dev)
    ari_planted_host = adjusted_rand_score(pop.strain, labels_host)
    results.update({
        "edges_dev": int(k_dev), "edges_host": int(k_host),
        "ari_same_threshold": float(ari_same_t),
        "ari_cross_boundary": round(float(ari_cross), 6),
        "ari_planted_dev": round(float(ari_planted_dev), 4),
        "ari_planted_host": round(float(ari_planted_host), 4),
        "n_clusters_dev": int(labels_dev.max()) + 1,
        "n_clusters_host": int(labels_host.max()) + 1,
    })
    sys.stderr.write(
        f"validate: same-threshold partitions identical "
        f"(ARI {ari_same_t}, {k_host} edges); cross-boundary ARI "
        f"{ari_cross:.6f}; planted ARI dev {ari_planted_dev:.4f} / "
        f"host {ari_planted_host:.4f}\n")
    _emit({
        "metric": f"validate streaming/device refine vs host "
                  f"full-fidelity at {n} (heavy strain imbalance)",
        "value": float(ari_same_t),
        "unit": "ARI(same-threshold partitions)",
        "vs_baseline": 1.0,
        "n": n, "detail": results,
        "wall_s_total": round(time.time() - t_all0, 1),
        "device": _device_record(),
    })


def bench_brandes_ab(n_comp=100, m=1000, deg=40, n_sources=100,
                     m_pad=1024):
    """Device batched Brandes vs the native OpenMP engine at the refine
    betweenness shapes.

    The refine-corners fixture's per-offset betweenness work is ~100
    strain components of ~1000 vertices, avg degree ~40, 100 sampled
    sources each (bench_refine_corners geometry). This A/B times exactly
    that unit of work: the device kernel runs ALL components x ALL
    sources as batched matmuls in one dispatch
    (ops/brandes_device.brandes_batched_device, f32 HIGHEST and a bf16
    variant); the native engine loops components under OpenMP
    (graph_core.cpp). Graphs are generated on each side with identical
    statistics (G(n, p), p = deg/m) — correctness is pinned separately
    in tests/test_brandes_device.py; this measures throughput, including
    the dispatch overhead a per-offset call would pay."""
    jax = _device_jax()
    import jax.numpy as jnp
    import scipy.sparse

    from poppunk_tpu.network.incremental import brandes_native
    from poppunk_tpu.ops.brandes_device import brandes_batched_device

    p = deg / m
    results = {}

    # --- native side: per-component CSR Brandes (the engine the 2-D
    # grid scoring drives per offset)
    rng = np.random.default_rng(0)
    comps = []
    for _ in range(n_comp):
        A = scipy.sparse.random(m, m, density=p / 2, format="coo",
                                rng=rng)
        A = ((A + A.T) > 0).astype(np.float64).tocsr()
        A.setdiag(0)
        A.eliminate_zeros()
        comps.append(A.astype(bool))
    sources = rng.choice(m, size=n_sources, replace=False)
    out0 = brandes_native(comps[0], sources)  # warm / availability
    if out0 is None:
        sys.stderr.write("native engine unavailable; skipping\n")
        return
    t0 = time.time()
    for A in comps:
        brandes_native(A, sources)
    results["native_s"] = time.time() - t0
    sys.stderr.write(f"native OpenMP: {n_comp} comps x {n_sources} "
                     f"sources in {results['native_s']:.2f}s\n")

    # --- device side: one dispatch, all components batched
    key = jax.random.PRNGKey(0)

    @jax.jit
    def make_adj(key):
        u = jax.random.uniform(key, (n_comp, m_pad, m_pad))
        a = (u < p / 2) & (jnp.arange(m_pad)[None, :, None]
                           < jnp.arange(m_pad)[None, None, :])
        a = a & (jnp.arange(m_pad)[None, None, :] < m)  # pad cols empty
        a = a & (jnp.arange(m_pad)[None, :, None] < m)
        return (a | a.transpose(0, 2, 1)).astype(jnp.float32)

    adj = make_adj(key)
    src = jnp.asarray(np.tile(sources[None], (n_comp, 1)), jnp.int32)
    for label, exact in (("device_f32_s", True), ("device_bf16_s", False)):
        bc = brandes_batched_device(adj, src, exact=exact)
        jax.block_until_ready(bc)  # compile + warm
        t0 = time.time()
        bc = brandes_batched_device(adj, src, exact=exact)
        jax.block_until_ready(bc)
        results[label] = time.time() - t0
        sys.stderr.write(f"{label[:-2]}: one dispatch, {n_comp} comps x "
                         f"{n_sources} sources in {results[label]:.3f}s\n")

    _emit({
        "metric": f"brandes A/B {n_comp} comps x {m} vertices deg {deg} "
                  f"x {n_sources} sources (per-offset betweenness unit)",
        "value": round(results["device_f32_s"], 3),
        "unit": "s",
        "vs_baseline": round(results["native_s"]
                             / results["device_f32_s"], 2),
        "detail": {k: round(v, 3) for k, v in results.items()},
    })


def bench_fill_profile(n=20480):
    """Localise the condensed-fill vs kernel-only gap at the fill's own
    shapes: (a) match kernel alone, (b) + fold/correction/fit, (c) the
    full stats step with fused kNN. Times a fixed 16-chunk slice, warm."""
    jax = _device_jax()
    import jax.numpy as jnp

    from poppunk_tpu.ops.distances import plane_geometry
    from poppunk_tpu.ops.match_kernel import match_counts, use_kernel
    from poppunk_tpu.scale import _fold_block
    from poppunk_tpu.synth import synthetic_population_device

    c = 128 if n > 32768 else 256
    steps = 16
    pop = synthetic_population_device(n, KLIST, SS64, BBITS,
                                      n_strains=max(20, n // 640), seed=2,
                                      chunk=2048)
    jax.block_until_ready(pop.planes)
    _, _, pad_bits = plane_geometry(SS64, BBITS)
    use_pallas = use_kernel()

    def rows2(planes, s):
        lo = jax.lax.dynamic_slice_in_dim(planes, s, c, axis=2)
        hi = jax.lax.dynamic_slice_in_dim(planes, n - s - c, c, axis=2)
        return jnp.concatenate([lo, hi], axis=2)

    @jax.jit
    def kernel_only(planes):
        def step(acc, s):
            m = match_counts(rows2(planes, s), planes, int(pad_bits),
                             plane_major=True)
            return acc + m.sum(dtype=jnp.int32), None

        starts = jnp.arange(steps, dtype=jnp.int32) * c
        acc, _ = jax.lax.scan(step, jnp.int32(0), starts)
        return acc

    def make_fold(consume_knn):
        @jax.jit
        def fold_pass(planes, lengths, freqs):
            def step(acc, s):
                folded, ti, td = _fold_block(
                    planes, lengths, freqs, s, c, KLIST, SS64, BBITS,
                    int(pad_bits), 5, 0, use_pallas)
                a = folded.sum(dtype=jnp.float32)
                if consume_knn:
                    a = a + td.sum(dtype=jnp.float32) + ti.sum(
                        dtype=jnp.int32).astype(jnp.float32)
                return acc + a, None

            starts = jnp.arange(steps, dtype=jnp.int32) * c
            acc, _ = jax.lax.scan(step, jnp.float32(0), starts)
            return acc

        return fold_pass

    pairs = 2 * c * steps * n  # full-row pair computations
    results = {}
    for name, fn, args in (
            ("kernel", kernel_only, (pop.planes,)),
            ("fold", make_fold(False),
             (pop.planes, pop.lengths, pop.freqs)),
            ("fold+knn", make_fold(True),
             (pop.planes, pop.lengths, pop.freqs))):
        np.asarray(fn(*args))  # compile + warm
        t0 = time.time()
        np.asarray(fn(*args))
        dt = time.time() - t0
        results[name] = pairs / dt
        sys.stderr.write(f"{name}: {dt:.2f}s = "
                         f"{pairs / dt / 1e6:.1f} M full-row pairs/s\n")

    # sweep-fill A/B at the same shapes: the sort-compaction pipeline
    # (_stream_sweep_group + count fetch + _fill_append) vs the direct
    # prefix-sum scatter append (_stream_fill_group)
    from poppunk_tpu.scale import (_fill_append, _line_d0_params,
                                   _stream_fill_group,
                                   _stream_sweep_group)
    from poppunk_tpu.ops.sparse_sweep import _bucket as _ss_bucket

    offsets = np.linspace(0.0, 0.35, 40)
    line = (0.05, 0.05, 0.6, 0.6)
    xm0, ym0, t_grid = _line_d0_params(offsets, 2, *line)
    scale_dev = jnp.asarray(
        np.array([0.6, 0.8], np.float32))
    t_dev = jnp.asarray(t_grid, jnp.float32)
    n_act = len(t_grid)
    e_alloc = _ss_bucket(pairs)

    def run_sort():
        bi = jnp.full(e_alloc, n, jnp.int32)
        bj = jnp.full(e_alloc, n, jnp.int32)
        bd = jnp.full(e_alloc, jnp.inf, jnp.float32)
        acc = 0
        pend = None
        for s in range(0, steps * c, 4 * c):
            out = _stream_sweep_group(
                pop.planes, pop.lengths, pop.freqs, jnp.int32(s),
                jnp.int32(n_act), scale_dev, t_dev, jnp.float32(xm0),
                jnp.float32(ym0), c, 4, KLIST, SS64, BBITS,
                int(pad_bits), 2, use_pallas, None)
            if pend is not None:
                pos, d0, count, m = pend
                k = int(count)
                b = min(_ss_bucket(max(k, 1)), m)
                bi, bj, bd = _fill_append(
                    bi, bj, bd, pos[:b], d0[:b], jnp.int32(k),
                    jnp.int32(acc), jnp.int32(s - 4 * c), n, int(b))
                acc += k
            pos, _, d0, count, _ = out
            pend = (pos, d0, count, 4 * c * (n - 1))
        pos, d0, count, m = pend
        k = int(count)
        b = min(_ss_bucket(max(k, 1)), m)
        bi, bj, bd = _fill_append(bi, bj, bd, pos[:b], d0[:b],
                                  jnp.int32(k),
                                  jnp.int32(acc),
                                  jnp.int32(steps * c - 4 * c), n, int(b))
        acc += k
        jax.block_until_ready(bd)
        return acc

    def run_direct():
        bi = jnp.full(e_alloc, n, jnp.int32)
        bj = jnp.full(e_alloc, n, jnp.int32)
        bd = jnp.full(e_alloc, jnp.inf, jnp.float32)
        acc_d = jnp.int32(0)
        for s in range(0, steps * c, 4 * c):
            bi, bj, bd, acc_d, _ = _stream_fill_group(
                bi, bj, bd, acc_d, pop.planes, pop.lengths, pop.freqs,
                jnp.int32(s), jnp.int32(n_act), scale_dev, t_dev,
                jnp.float32(xm0), jnp.float32(ym0), c, 4, KLIST, SS64,
                BBITS, int(pad_bits), 2, use_pallas, None)
        return int(acc_d)

    # the fused stats+fill kernel (the bootstrap pass-1 body): measures
    # whether fusing the two epilogues onto one enumeration costs more
    # than the sum of its parts (VMEM/register pressure in the scan)
    from poppunk_tpu.scale import _stream_stats_fill_range

    def run_fused():
        bi = jnp.full(e_alloc, n, jnp.int32)
        bj = jnp.full(e_alloc, n, jnp.int32)
        bd = jnp.full(e_alloc, jnp.inf, jnp.float32)
        acc_d = jnp.int32(0)
        ki = jnp.zeros((n, 5), jnp.int32)
        kd = jnp.zeros((n, 5), jnp.float32)
        cmax = jnp.full((2,), -jnp.inf, jnp.float32)
        for s in range(0, steps * c, 4 * c):
            ki, kd, cmax, bi, bj, bd, acc_d, _ = _stream_stats_fill_range(
                pop.planes, pop.lengths, pop.freqs, ki, kd, cmax,
                bi, bj, bd, acc_d, jnp.int32(s), jnp.int32(n_act),
                scale_dev, t_dev, jnp.float32(xm0), jnp.float32(ym0),
                c, 4, KLIST, SS64, BBITS, int(pad_bits), 5, 0,
                use_pallas, 2, None)
        return int(acc_d)

    for name, fn in (("sweep-sort", run_sort),
                     ("sweep-direct", run_direct),
                     ("stats+fill-fused", run_fused)):
        k_warm = fn()  # compile + warm
        t0 = time.time()
        k2 = fn()
        dt = time.time() - t0
        assert k2 == k_warm
        results[name] = pairs / dt
        sys.stderr.write(f"{name}: {dt:.2f}s = "
                         f"{pairs / dt / 1e6:.1f} M full-row pairs/s "
                         f"({k2} edges)\n")

    print(json.dumps({
        "metric": f"fill profile n={n} c={c} (full-row pairs/s)",
        "value": round(results["fold+knn"], 1),
        "unit": "pairs/s",
        "vs_baseline": round(results["fold+knn"] / results["kernel"], 3),
        "detail": {k: round(v / 1e6, 2) for k, v in results.items()},
    }))


def main():
    global JSON_OUT
    if "--json-out" in sys.argv:
        JSON_OUT = sys.argv[sys.argv.index("--json-out") + 1]
    if "--capture" in sys.argv:
        bench_capture()  # orchestrates subprocesses; no backend needed here
        return
    if "--sketch" in sys.argv:
        bench_sketch()  # host-only
        return
    if "--refine-corners" in sys.argv:
        bench_refine_corners()  # host-only
        return
    if "--serve-prod" in sys.argv:
        bench_serving_prod()
        return
    if "--serve" in sys.argv:
        bench_serving()
        return
    if "--brandes-ab" in sys.argv:
        bench_brandes_ab()
        return
    if "--validate" in sys.argv:
        pos = sys.argv.index("--validate")
        n = (int(sys.argv[pos + 1]) if len(sys.argv) > pos + 1
             and sys.argv[pos + 1].isdigit() else 24576)
        bench_validate(n)
        return
    if "--fill-profile" in sys.argv:
        pos = sys.argv.index("--fill-profile")
        n = int(sys.argv[pos + 1]) if len(sys.argv) > pos + 1 else 20480
        bench_fill_profile(n)
        return
    if "--colshard" in sys.argv:
        pos = sys.argv.index("--colshard")
        n = int(sys.argv[pos + 1]) if len(sys.argv) > pos + 1 else 16384
        bench_colshard(n)
        return
    if "--scale" in sys.argv:
        pos = sys.argv.index("--scale")
        n = int(sys.argv[pos + 1]) if len(sys.argv) > pos + 1 else 20480
        bench_scale(n)
        return
    threads = os.cpu_count() or 1
    dev_rate, planes64 = bench_device(nq=2048, nr=4096)

    try:
        lib = _build_baseline()
        cq, cr = 512, 1024
        cpu_rate = bench_cpu(lib, planes64, cq, cr, threads)
    except Exception as e:  # noqa: BLE001 — baseline failure isn't fatal
        sys.stderr.write(f"cpu baseline failed: {e}\n")
        cpu_rate = float("nan")

    # vs_baseline uses the PINNED dedicated-run CPU rate (BASELINE.json)
    # so the headline ratio is stable across rounds; the live co-run
    # measurement (depressed by whatever else the host is doing) is
    # reported alongside
    pinned = _pinned_cpu_rate()
    out = {
        "metric": "pairwise core/accessory dists/sec/device "
                  "(sketchsize 9984, bbits 14, 6 k-mer lengths)",
        "value": round(dev_rate, 1),
        "unit": "pairs/s",
        "vs_baseline": round(dev_rate / (pinned or cpu_rate), 2)
        if (pinned or cpu_rate == cpu_rate) else None,
        "vs_baseline_live": round(dev_rate / cpu_rate, 2)
        if cpu_rate == cpu_rate else None,
        "device": _device_record(),
    }
    _emit(out)


if __name__ == "__main__":
    main()
