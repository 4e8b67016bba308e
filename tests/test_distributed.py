"""True multi-process jax.distributed test: two controller processes, four
virtual CPU devices each, gloo collectives between them — the CPU stand-in
for a 2-host cluster (SURVEY.md §5.8: the reference has no distributed
execution at all; this path is this framework's replacement). The sharded
distance block computed across process boundaries must equal the
single-process result, and every host must see the full gathered output."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    proc_id = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    out_npz = sys.argv[4]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from poppunk_tpu import configure_jax_cache
    configure_jax_cache()
    from poppunk_tpu.parallel.distributed import (init_distributed,
                                                  is_primary, pod_mesh)
    ok = init_distributed(coordinator_address="localhost:" + port,
                          num_processes=nproc, process_id=proc_id)
    assert ok, "init_distributed returned False"
    assert jax.process_count() == nproc
    assert jax.device_count() == 4 * nproc
    mesh = pod_mesh()
    # one query shard per host, r axis inside each process's devices
    assert dict(mesh.shape) == {{"q": nproc, "r": 4}}
    assert is_primary() == (proc_id == 0)

    import numpy as np
    from poppunk_tpu.parallel.dists import sharded_pairwise_block
    KLIST = (15, 18, 21); SS64 = 16; BBITS = 4
    from poppunk_tpu.ops.distances import plane_geometry
    _, wp, _ = plane_geometry(SS64, BBITS)
    def synth(n, seed):
        rng = np.random.default_rng(seed)
        w32 = 2 * SS64
        p = np.zeros((n, len(KLIST), BBITS, wp), dtype=np.uint32)
        p[..., :w32] = rng.integers(0, 2**32, (n, len(KLIST), BBITS, w32),
                                    dtype=np.uint32)
        return (p, rng.integers(1_000_000, 2_000_000, n).astype(np.int32),
                rng.dirichlet(np.ones(4), n).astype(np.float32))
    pq, lq, fq = synth(10, 1)
    pr, lr, fr = synth(23, 2)
    got = sharded_pairwise_block(mesh, pq, pr, lq, lr, fq, fr, KLIST,
                                 SS64, BBITS, use_pallas=False)
    if proc_id == 0:
        np.savez(out_npz, got=got)
    print("WORKER_DONE", proc_id)
""").format(repo=REPO)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


PIPELINE_WORKER = textwrap.dedent("""
    import os, sys
    proc_id = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    outdir = sys.argv[4]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from poppunk_tpu import configure_jax_cache
    configure_jax_cache()
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    from poppunk_tpu.parallel.distributed import init_distributed
    assert init_distributed(coordinator_address="localhost:" + port,
                            num_processes=nproc, process_id=proc_id)
    assert jax.device_count() == 4 * nproc

    # force the sharded distance path even at toy problem sizes so the
    # whole pipeline's distance stages really cross process boundaries
    import poppunk_tpu.ops.distances as dist_ops
    dist_ops._SHARD_MIN_PAIRS = 1

    from synth_genomes import SyntheticPopulation
    pop = SyntheticPopulation(n_strains=4, genomes_per_strain=(5, 4, 3, 3),
                              genome_length=80_000, core_mutation_rate=0.008,
                              between_divergence=0.035, accessory_pool=40,
                              accessory_gene_len=2_000, seed=20260816)
    gen_dir = os.path.join(outdir, "genomes" + str(proc_id))
    os.makedirs(gen_dir, exist_ok=True)
    pop.write_fastas(gen_dir)
    refs = [n for n in pop.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in pop.names if n not in refs]
    rfile = pop.subset_rfile(gen_dir, refs, "refs.txt")
    qfile = pop.subset_rfile(gen_dir, queries, "queries.txt")

    KARGS = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
             "--sketch-size", "2048", "--no-plot"]
    from poppunk_tpu.cli.main import main as poppunk_main
    from poppunk_tpu.cli.assign import main as assign_main
    db = os.path.join(outdir, "db" + str(proc_id))
    poppunk_main(["--create-db", "--r-files", rfile, "--output", db] + KARGS)
    poppunk_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
                  "--K", "2", "--no-plot"])
    assign_out = os.path.join(outdir, "assign" + str(proc_id))
    assign_main(["--db", db, "--query", qfile, "--output", assign_out])
    print("WORKER_DONE", proc_id)
""").format(repo=REPO)


@pytest.mark.slow
def test_two_process_sharded_dists(tmp_path):
    port = _free_port()
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    out_npz = str(tmp_path / "result.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(i), "2", str(port), out_npz],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert "WORKER_DONE" in out

    # cross-process result equals the in-process single-mesh result
    from poppunk_tpu.ops.distances import pairwise_block, plane_geometry

    KLIST = (15, 18, 21)
    SS64, BBITS = 16, 4
    _, wp, _ = plane_geometry(SS64, BBITS)

    def synth(n, seed):
        rng = np.random.default_rng(seed)
        w32 = 2 * SS64
        p = np.zeros((n, len(KLIST), BBITS, wp), dtype=np.uint32)
        p[..., :w32] = rng.integers(0, 2**32, (n, len(KLIST), BBITS, w32),
                                    dtype=np.uint32)
        return (p, rng.integers(1_000_000, 2_000_000, n).astype(np.int32),
                rng.dirichlet(np.ones(4), n).astype(np.float32))

    pq, lq, fq = synth(10, 1)
    pr, lr, fr = synth(23, 2)
    want = np.asarray(pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64,
                                     BBITS, use_pallas=False,
                                     use_mesh=False))
    got = np.load(out_npz)["got"]
    assert got.shape == want.shape == (10, 23, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.slow
def test_two_process_full_pipeline(tmp_path, population, population_dir,
                                   tmp_path_factory):
    """create-db -> fit-model bgmm -> assign runs end-to-end under
    jax.distributed (two controllers, sharded distance stages forced), and
    every artefact that matters — reference cluster CSV and the assigned
    query clusters — is identical across both workers AND equal to the
    single-process run."""
    import csv

    port = _free_port()
    worker_py = tmp_path / "pipeline_worker.py"
    worker_py.write_text(PIPELINE_WORKER)
    outdir = str(tmp_path / "work")
    os.makedirs(outdir)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(i), "2", str(port), outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("pipeline workers timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        assert "WORKER_DONE" in out

    def read_clusters(path):
        with open(path) as f:
            return {name: cl for name, cl in list(csv.reader(f))[1:]}

    ref0 = read_clusters(os.path.join(outdir, "db0", "db0_clusters.csv"))
    ref1 = read_clusters(os.path.join(outdir, "db1", "db1_clusters.csv"))
    assert ref0 == ref1
    q0 = read_clusters(
        os.path.join(outdir, "assign0", "assign0_clusters.csv"))
    q1 = read_clusters(
        os.path.join(outdir, "assign1", "assign1_clusters.csv"))
    assert q0 == q1

    # single-process twin on the same population (same seed, same flags)
    from poppunk_tpu.cli.assign import main as assign_main
    from poppunk_tpu.cli.main import main as poppunk_main

    d, _ = population_dir
    refs = [n for n in population.names
            if not n.startswith("strain3") and not n.endswith("iso0")]
    queries = [n for n in population.names if n not in refs]
    rfile = population.subset_rfile(d, refs, "dist_refs.txt")
    qfile = population.subset_rfile(d, queries, "dist_queries.txt")
    db = str(tmp_path / "sp_db")
    kargs = ["--min-k", "13", "--max-k", "25", "--k-step", "4",
             "--sketch-size", "2048", "--no-plot"]
    poppunk_main(["--create-db", "--r-files", rfile, "--output", db] + kargs)
    poppunk_main(["--fit-model", "bgmm", "--ref-db", db, "--output", db,
                  "--K", "2", "--no-plot"])
    sp_out = str(tmp_path / "sp_assign")
    assign_main(["--db", db, "--query", qfile, "--output", sp_out])

    sp_ref = read_clusters(os.path.join(db, "sp_db_clusters.csv"))
    sp_q = read_clusters(os.path.join(sp_out, "sp_assign_clusters.csv"))
    # cluster NAMES depend only on size/appearance order; mappings must
    # match the distributed run exactly
    assert sp_ref == ref0
    assert sp_q == q0
