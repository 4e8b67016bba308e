"""Smoke test of the main path on one GPU, end to end.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the sharded path only

Phases (one process; each raises on failure):

  db10k    a whole-species database at the reference's documented E. coli
           geometry (10,287 samples, k = 15..27 step 3, sketch size 9984;
           here n = 10240, bbits = 14): 10240 + 384 genomes synthesised on
           the device, fitted by poppunk_tpu_scale's streaming fit, then
           served by an AssignSession in three batches of 128 held-out
           genomes. Checks the ARI of the clusters against the planted
           strains (>= 0.99) and that >= 99% of the queries join their
           strain's cluster.
  kernels  the bin-match kernel as compiled for the card against the numpy
           oracle, 256 queries x 10240 references, both layouts, K = 5 and
           6 (bit-identical), and the fused core/accessory distances
           against the float64 numpy path (<= 1e-5 absolute).
  gpu-tests  ``pytest -m gpu tests/test_gpu.py`` in this process.

The reference's bundled-test phase (``poppunk_tpu --create-db`` on FASTA
files) needs h5py, which the GPU machine lacks; the sketches here stay in
memory instead of an HDF5 database.

``--four-cards`` fits the db10k population with and without the device
mesh and compares the cluster assignments, and compares pairwise_block on
512 x 10240 with and without the mesh.

The card's name and power limit are printed first; the last line is one
JSON object with the device as JAX reports it. Without a GPU the script
exits non-zero before printing any result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KLIST = (15, 18, 21, 24, 27)
SS64 = 156  # sketch size 9984
BBITS = 14


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def make_population(n, n_held, seed=1):
    """(ref sketches, held-out sketches, ref strains, held-out strains):
    n + n_held genomes synthesised on the device; the held-out genomes are
    a stride through the strain-ordered population."""
    import jax

    from poppunk_tpu.ops.distances import unpack_planes
    from poppunk_tpu.synth import synthetic_population_device

    pop = synthetic_population_device(n + n_held, KLIST, SS64, BBITS,
                                      n_strains=20, seed=seed, chunk=2048)
    jax.block_until_ready(pop.planes)
    strain = np.asarray(pop.strain)
    held = np.arange(n_held) * ((n + n_held) // n_held)
    refs = np.setdiff1d(np.arange(n + n_held), held)
    planes = np.asarray(pop.planes)
    lengths, freqs = np.asarray(pop.lengths), np.asarray(pop.freqs)

    def sketches(idx, prefix):
        names = [f"{prefix}{i:05d}" for i in range(len(idx))]
        return unpack_planes(planes[:, :, idx], lengths[idx], freqs[idx],
                             KLIST, SS64, names, plane_major=True)

    return (sketches(refs, "ref"), sketches(held, "query"), strain[refs],
            strain[held])


def fit_clusters(sketches, out, mesh):
    """poppunk_tpu_scale's fit on in-memory sketches; {name: cluster}."""
    from poppunk_tpu.cli.scale import fit_sketches
    from poppunk_tpu.utils import read_isolate_type_from_csv

    args = ["--ref-db", out, "--output", out, "--no-plot"]
    if not mesh:
        args.append("--single-device")
    fit_sketches(args, sketches, KLIST)
    csv = os.path.join(out, os.path.basename(out) + "_clusters.csv")
    return read_isolate_type_from_csv(csv, return_dict=True)["Cluster"]


def phase_db10k(workdir, n=10240, n_held=384, batch=128):
    import jax

    from poppunk_tpu import profiling
    from poppunk_tpu.memory import memory_plan
    from poppunk_tpu.serve import AssignSession
    from poppunk_tpu.utils import adjusted_rand_index

    t0 = time.perf_counter()
    refs, queries, ref_strain, query_strain = make_population(n, n_held)
    log(f"db10k: {n} + {n_held} genomes synthesised in "
        f"{time.perf_counter() - t0:.1f}s")

    profiling.reset()
    profiling.enable(True)
    out = os.path.join(workdir, "db10k")
    clusters = fit_clusters(refs, out, mesh=False)
    labels = [clusters[s.name] for s in refs]
    ari = adjusted_rand_index(ref_strain, labels)
    stages = {k: v[0] for k, v in profiling.timings().items()}
    log(f"db10k: ARI vs planted strains {ari:.6f} "
        f"({len(set(labels))} clusters, 20 planted)")

    session = AssignSession.from_sketches(refs, out)
    strain_cluster = {}
    for s, c in zip(ref_strain, labels):
        strain_cluster.setdefault(int(s), []).append(c)
    strain_cluster = {s: max(set(cs), key=cs.count)
                      for s, cs in strain_cluster.items()}
    hits = 0
    for b in range(n_held // batch):
        sl = slice(b * batch, (b + 1) * batch)
        t1 = time.perf_counter()
        got = session.assign_sketches(queries[sl])
        dt = time.perf_counter() - t1
        key = "assign batch 1" if b == 0 else "assign batches 2-3"
        stages[key] = stages.get(key, 0.0) + dt
        hits += sum(got[q.name] == strain_cluster[int(s)]
                    for q, s in zip(queries[sl], query_strain[sl]))
    share = hits / n_held
    for name, secs in stages.items():
        log(f"db10k: stage {name}: {secs:.3f} s")
    log(f"db10k: {hits}/{n_held} queries assigned to their planted "
        f"strain's cluster ({share:.4f})")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"db10k: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    log(f"db10k: memory plan {memory_plan()._asdict()}")
    if ari < 0.99:
        raise AssertionError(f"db10k ARI {ari} < 0.99")
    if share < 0.99:
        raise AssertionError(f"db10k assigned share {share} < 0.99")
    return refs, queries


def oracle_counts(q64, r64):
    """numpy bin-match counts [nq, nr] for one k: uint64 [n, P, W64]."""
    from concurrent.futures import ThreadPoolExecutor

    def rows(lo):
        q = q64[lo:lo + 8]
        diff = np.zeros((q.shape[0], r64.shape[0], r64.shape[2]), np.uint64)
        for p in range(q64.shape[1]):
            diff |= q[:, None, p, :] ^ r64[None, :, p, :]
        return 64 * r64.shape[2] - np.bitwise_count(diff).sum(
            axis=-1, dtype=np.int64)

    with ThreadPoolExecutor(8) as pool:
        return np.concatenate(list(pool.map(rows, range(0, len(q64), 8))))


def phase_kernels(refs=None, queries=None, nq=256, nr=10240, n_dist=64):
    import jax
    import jax.numpy as jnp

    from poppunk_tpu.ops import jaccard_np
    from poppunk_tpu.ops.distances import (pack_planes, pairwise_block,
                                           plane_geometry)
    from poppunk_tpu.ops.kmer_fit import _fit_math
    from poppunk_tpu.ops.match_kernel import match_counts, use_kernel
    from poppunk_tpu.sketch.random_match import random_jaccard

    if not use_kernel():
        raise AssertionError("the dispatcher did not pick the GPU kernel")
    rng = np.random.default_rng(7)
    for K in (5, 6):
        u64 = rng.integers(0, 2**64 - 1, (nr, K, BBITS, SS64),
                           dtype=np.uint64, endpoint=True)
        u32 = u64.view(np.uint32)  # the device layout: (low, high) words
        _, wp, pad_bits = plane_geometry(SS64, BBITS)
        assert wp == u32.shape[-1], "production geometry is unpadded"
        genome_major = jnp.asarray(u32)
        plane_major = jnp.asarray(np.ascontiguousarray(
            u32.transpose(1, 2, 0, 3)))
        got_g = np.asarray(match_counts(genome_major[:nq], genome_major,
                                        pad_bits))
        got_p = np.asarray(match_counts(plane_major[:, :, :nq], plane_major,
                                        pad_bits, plane_major=True))
        del genome_major, plane_major
        for k in range(K):
            want = oracle_counts(u64[:nq, k], u64[:, k])
            for layout, got in (("genome-major", got_g),
                                ("plane-major", got_p)):
                err = int(np.abs(got[..., k].astype(np.int64) - want).max())
                log(f"kernels: K={K} k#{k} {layout} {nq}x{nr}: "
                    f"max |kernel - oracle| = {err}")
                if err:
                    raise AssertionError(f"match counts differ ({layout})")

    if refs is None:
        return
    # fused distances on the db10k sketches vs the float64 numpy path
    q = queries[:n_dist]
    pq, lq, fq = pack_planes(q, KLIST)
    pr, lr, fr = pack_planes(refs, KLIST)
    got = pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                         use_mesh=False)
    matches = np.asarray(match_counts(jnp.asarray(pq), jnp.asarray(pr),
                                      plane_geometry(SS64, BBITS)[2]))
    jac = np.empty(matches.shape, np.float64)
    for ki, k in enumerate(KLIST):
        j = jaccard_np.jaccard_from_matches(matches[..., ki], SS64, BBITS)
        r = random_jaccard(k, lq[:, None], lr[None, :], fq[:, None, :],
                           fr[None, :, :])
        jac[..., ki] = jaccard_np.random_correct(j, r)
    core, acc = _fit_math(np, jac, np.asarray(KLIST, np.float64))
    want = np.stack([core, acc], axis=-1)
    err = float(np.abs(got - want).max())
    log(f"kernels: core/accessory {n_dist}x{len(refs)} vs float64: "
        f"max abs error {err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"distances differ from float64 by {err}")


def phase_gpu_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {rc}")


def phase_four_cards(workdir, n=10240, n_queries=512):
    import jax

    from poppunk_tpu.ops.distances import pack_planes, pairwise_block

    if jax.device_count() != 4:
        raise AssertionError(f"--four-cards needs 4 devices, "
                             f"found {jax.device_count()}")
    refs, queries, _, _ = make_population(n, n_queries)
    one = fit_clusters(refs, os.path.join(workdir, "one"), mesh=False)
    four = fit_clusters(refs, os.path.join(workdir, "four"), mesh=True)
    same = all(one[k] == four[k] for k in one) and one.keys() == four.keys()
    log(f"four-cards: cluster assignments identical: {same} "
        f"({len(set(one.values()))} clusters)")
    if not same:
        raise AssertionError("sharded fit clusters differ from one card")
    pq, lq, fq = pack_planes(queries, KLIST)
    pr, lr, fr = pack_planes(refs, KLIST)
    d1 = pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                        use_mesh=False)
    d4 = pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                        use_mesh=True)
    err = float(np.abs(d1 - d4).max())
    log(f"four-cards: pairwise_block {len(queries)}x{len(refs)} mesh vs "
        f"one device: max abs difference {err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"sharded distances differ by {err}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run the sharded path on four GPUs only")
    args = parser.parse_args()

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's device is {device.platform})")
    from poppunk_tpu import configure_jax_cache

    configure_jax_cache()
    log(card_line())
    with tempfile.TemporaryDirectory() as workdir:
        if args.four_cards:
            phase_four_cards(workdir)
        else:
            refs, queries = phase_db10k(workdir)
            phase_kernels(refs, queries)
            del refs, queries
            phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
