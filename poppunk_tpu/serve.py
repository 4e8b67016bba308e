"""Resident serving session for query assignment.

The CLI path (assign.py, mirroring PopPUNK/assign.py) re-reads the sketch
database, re-packs the reference plane tensor and re-uploads it on every
invocation — correct for batch jobs, wasteful for a serving daemon
answering many small requests (the BeeBOP web flow calls assignment per
upload). ``AssignSession`` pays those costs once:

- reference sketches are read, packed and placed on device at
  construction, and stay resident across requests;
- the fitted model's classifier is fused into the distance dispatch
  (ops/fused_assign);
- stable mode ("core"/"accessory") additionally fuses the 1-NN search, so
  a request fetches O(queries) integers from the device — the |Q|x|R|
  distance tile never leaves HBM;
- query batches are bucketed to powers of two, so after ``warmup()``
  (or the first few requests) no batch size pays a compile.

Semantics match ``poppunk_assign --stable {core,accessory}``
(reference assign.py:663-693): each query takes its nearest reference's
cluster iff that pair is within-strain, else "NA". Sessions serve
refine/threshold, BGMM and DBSCAN models. DBSCAN's approximate_predict
(reference PopPUNK/models.py:192) needs a per-pair kNN against the fitted
point set — costlier than the distance kernel itself — so at construction
the decision function is quantised onto a 1024^2 grid over scaled distance
space (DBSCANFit.decision_grid, evaluated with the exact host predictor)
and serving classifies each pair with one device gather; exact for any
pair more than half a cell (~1e-3 of the distance range) from a decision
boundary.
"""

import os

import jax.numpy as jnp
import numpy as np

from .ops.distances import _dist_chunk, pack_planes, plane_geometry
from .ops.match_kernel import use_kernel
from .utils import db_h5_path, read_isolate_type_from_csv


def _file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


class AssignSession:
    def __init__(self, ref_db, model_dir=None, stable="core",
                 use_full_network=False, strand_preserved=False, chunk=512):
        from .io.hdf5db import get_seqs_in_db, read_db_params, read_sketches

        self.ref_db = ref_db = ref_db.rstrip("/")
        model_prefix = (model_dir or ref_db).rstrip("/")
        base = _file_base(model_prefix)
        kmers = read_db_params(ref_db)[0]

        # serving reference set: the clique-pruned .refs subset if present.
        # Reference ORDER follows the .dists pkl when available — the CLI
        # stable path takes r_names from read_pickle(distances)
        # (assign.py), and 1-NN tie-breaking is "first min", so a
        # different order could resolve duplicate-genome ties to a
        # different cluster than poppunk_assign --stable.
        dist_pkl = _file_base(ref_db) + ".dists"
        if os.path.isfile(dist_pkl + ".pkl"):
            from .utils import read_pickle

            all_names = read_pickle(dist_pkl, distances=False)[0]
        else:
            all_names = get_seqs_in_db(db_h5_path(ref_db))
        r_names = None
        refs_file = base + ".refs"
        if os.path.isfile(refs_file) and not use_full_network:
            with open(refs_file) as f:
                wanted = frozenset(line.rstrip() for line in f)
            r_names = [n for n in all_names if n in wanted]
        elif os.path.isfile(dist_pkl + ".pkl"):
            r_names = list(all_names)
        sketches = read_sketches(ref_db, r_names)
        self._setup(sketches, kmers, model_prefix, stable, strand_preserved,
                    chunk)

    @classmethod
    def from_sketches(cls, sketches, model_dir, stable="core",
                      strand_preserved=False, chunk=512):
        """A session over reference sketches already in memory, in the
        order of the fit's .dists.pkl, with the fitted model and clusters
        in ``model_dir`` (no sketch database is read)."""
        self = cls.__new__(cls)
        self.ref_db = None
        self._setup(sketches, sorted(sketches[0].usigs), model_dir.rstrip("/"),
                    stable, strand_preserved, chunk)
        return self

    def _setup(self, sketches, kmers, model_prefix, stable, strand_preserved,
               chunk):
        from .models import load_cluster_fit

        base = _file_base(model_prefix)
        self.model = load_cluster_fit(base + "_fit.pkl", base + "_fit.npz")
        if self.model.type not in ("refine", "bgmm", "dbscan"):
            raise RuntimeError(
                "AssignSession serves refine/threshold/bgmm/dbscan models; "
                "got " + self.model.type)
        if stable not in ("core", "accessory"):
            raise ValueError("stable must be 'core' or 'accessory'")
        self.stable = stable
        self.chunk = chunk
        self.use_rc = not strand_preserved
        self.kmers = tuple(int(k) for k in kmers)
        self.r_names = [s.name for s in sketches]
        self.ss64 = sketches[0].sketchsize64
        self.bbits = sketches[0].bbits
        _, _, self.pad_bits = plane_geometry(self.ss64, self.bbits)
        planes_r, len_r, freq_r = pack_planes(sketches, self.kmers)
        self.planes_r = jnp.asarray(planes_r)   # device-resident
        self.len_r = jnp.asarray(len_r)
        self.freq_r = jnp.asarray(freq_r)

        # reference clustering for cluster names
        cluster_csv = base + "_clusters.csv"
        self.ref_clustering = read_isolate_type_from_csv(
            cluster_csv, mode="clusters", return_dict=True)["Cluster"]

        # fused classifier + 1-NN spec
        from .ops.fused_assign import stable_post_spec

        dist_col = 0 if stable == "core" else 1
        self.post_spec = stable_post_spec(self.model, dist_col)
        if self.post_spec is None:  # not assert: must survive python -O
            raise RuntimeError(
                f"no fused classifier for model type {self.model.type}")

    def _dispatch_async(self, planes_q, len_q, freq_q):
        """One fused dispatch: dists + classification + 1-NN on device.
        Returns the DEVICE int32[nq, 2] of (nn_index, within) without
        synchronising — callers overlap the next batch's device work
        with this one's host fetch/attach."""
        _, extra = _dist_chunk(
            jnp.asarray(planes_q), self.planes_r, jnp.asarray(len_q),
            self.len_r, jnp.asarray(freq_q), self.freq_r,
            self.kmers, self.ss64, self.bbits, self.pad_bits,
            True, self.use_rc, False, use_kernel(), *self.post_spec)
        return extra

    def _dispatch(self, planes_q, len_q, freq_q):
        """Synchronous _dispatch_async (warmup / single-batch callers)."""
        return np.asarray(self._dispatch_async(planes_q, len_q, freq_q))

    def assign_sketches(self, sketches):
        """{query name: cluster or 'NA'} for already-sketched queries.

        Double-buffered: batch i+1's fused device dispatch is queued
        BEFORE batch i's result is fetched and attached, so the host
        attach rides under the accelerator's compute instead of after it
        (the round-3 production-serve gap was exactly this serial
        host tail)."""
        bad = [s.name for s in sketches
               if s.sketchsize64 != self.ss64 or s.bbits != self.bbits]
        if bad:
            # same-Wp mismatches (e.g. ss64 32 vs 64 both pad to one lane
            # tile) would pass every shape check and return confidently
            # wrong clusters
            raise ValueError(
                f"query sketch geometry does not match the reference db "
                f"(sketchsize64={self.ss64}, bbits={self.bbits}): "
                + ", ".join(bad[:5]))
        planes_q, len_q, freq_q = pack_planes(sketches, self.kmers)
        out = {}

        def attach(extra_d, sl, n):
            extra = np.asarray(extra_d)[:n]
            for sk, (nn, within) in zip(sketches[sl], extra):
                out[sk.name] = (self.ref_clustering[self.r_names[int(nn)]]
                                if within else "NA")

        pending = None
        for start in range(0, len(sketches), self.chunk):
            sl = slice(start, min(start + self.chunk, len(sketches)))
            n = sl.stop - sl.start
            bucket = 1
            while bucket < n:
                bucket *= 2
            pad = bucket - n
            pq = planes_q[sl]
            lq = np.asarray(len_q[sl])
            fq = np.asarray(freq_q[sl])
            if pad:
                pq = np.pad(pq, ((0, pad),) + ((0, 0),) * 3)
                lq = np.pad(lq, (0, pad), constant_values=1)
                fq = np.pad(fq, ((0, pad), (0, 0)))
            extra_d = self._dispatch_async(pq, lq, fq)
            if pending is not None:
                attach(*pending)
            pending = (extra_d, sl, n)
        if pending is not None:
            attach(*pending)
        return out

    def assign_files(self, q_files, threads=1):
        """Sketch query inputs (an rfile path, or a (names, files) pair
        of parallel lists) then assign — no query database is written.
        Returns {name: cluster or 'NA'}."""
        from .sketch.minhash import _sketch_one
        from .sketch.minhash import SketchParams
        from .utils import read_rfile

        if isinstance(q_files, (tuple, list)) and len(q_files) == 2 \
                and not isinstance(q_files[0], str):
            names, sequences = list(q_files[0]), list(q_files[1])
        elif isinstance(q_files, str):
            names, sequences = read_rfile(q_files)
        else:
            raise TypeError(
                "q_files must be an rfile path or a (names, files) pair "
                "of parallel lists")
        params = SketchParams(klist=self.kmers, sketchsize64=self.ss64,
                              bbits=self.bbits, use_rc=self.use_rc)
        if threads > 1 and len(names) > 1:
            from multiprocessing import get_context

            # spawn, not fork: __init__ already started the JAX backend
            # (device-resident reference tensor), and forking after
            # client init can deadlock children on inherited runtime
            # mutexes. native_threads=1 per job: P workers x
            # min(n_k, cores) OpenMP threads oversubscribes the host
            # (same discipline as construct_database's pool)
            jobs = [(n, f, params, 1) for n, f in zip(names, sequences)]
            with get_context("spawn").Pool(min(threads, len(jobs))) as pool:
                sketches = pool.map(_sketch_one, jobs)
        else:
            sketches = [_sketch_one((n, f, params))
                        for n, f in zip(names, sequences)]
        return self.assign_sketches(sketches)

    def warmup(self):
        """Compile every bucket-size program before taking traffic."""
        n = 0
        bucket = 1
        K, P = len(self.kmers), self.bbits
        wp = self.planes_r.shape[-1]
        while True:
            self._dispatch(
                np.zeros((bucket, K, P, wp), np.uint32),
                np.ones(bucket, np.int32), np.zeros((bucket, 4), np.float32))
            n += 1
            if bucket >= self.chunk:
                return n
            bucket *= 2
