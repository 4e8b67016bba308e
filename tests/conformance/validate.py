"""One-command pp-sketchlib conformance validator.

    python tests/conformance/validate.py

Always: replays the committed FASTA/FASTQ inputs through this
framework's sketch + distance pipeline (native C++ core AND the numpy
twin) and checks every byte-pinned expectation in ``expected.json`` —
any drift in the hash/bin/densify/pack/distance stack fails loudly.

When a ``pp_sketchlib`` wheel is importable (none is reachable in the
build sandbox — zero egress), additionally cross-validates bit-exactness
against the reference implementation itself: the sketch planes it
computes for the same inputs must hash identically, and its
queryDatabase jaccards must match to float tolerance
(PopPUNK/sketchlib.py:348-434 constructDatabase, :635-670 queryDatabase).
Exit code 0 = all checks passed.
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_expected():
    with open(os.path.join(HERE, "expected.json")) as fh:
        return json.load(fh)


def our_sketches(exp, use_native):
    from poppunk_tpu.sketch.minhash import SketchParams, sketch_sequence
    from poppunk_tpu.sketch.reader import read_sequence_input

    params = SketchParams(klist=tuple(exp["klist"]),
                          sketchsize64=exp["sketchsize64"],
                          bbits=exp["bbits"], use_rc=True,
                          min_count=exp["min_count"])
    out = []
    for name, files in sorted(exp["inputs"].items()):
        paths = [os.path.join(HERE, f) for f in files]
        codes, length, missing, is_reads = read_sequence_input(paths)
        if use_native:
            sk = sketch_sequence(name, codes, params, length=length,
                                 missing_bases=missing, reads=is_reads)
        else:
            from poppunk_tpu.sketch.minhash import Sketch, sketch_codes

            usigs, densified = sketch_codes(codes, params, reads=is_reads,
                                            use_native=False)
            real = codes != 4
            sk = Sketch(name=name, usigs=usigs, length=length,
                        densified=densified,
                        base_freq=np.bincount(codes[real], minlength=4)
                        / max(int(real.sum()), 1),
                        missing_bases=missing,
                        sketchsize64=exp["sketchsize64"],
                        bbits=exp["bbits"])
        out.append(sk)
    return out


def check_ours(exp):
    from poppunk_tpu.ops.distances import query_db
    from poppunk_tpu.pairs import iter_dist_rows

    failures = []
    for label, use_native in (("native", True), ("numpy", False)):
        sketches = our_sketches(exp, use_native)
        for sk in sketches:
            want = exp["sketches"][sk.name]
            if int(sk.length) != want["length"]:
                failures.append(f"{label}: {sk.name} length {sk.length} "
                                f"!= {want['length']}")
            for k_str, digest in want["usig_sha256"].items():
                got = hashlib.sha256(
                    sk.usigs[int(k_str)].tobytes()).hexdigest()
                if got != digest:
                    failures.append(
                        f"{label}: {sk.name} k={k_str} sketch hash drift")
        names = [sk.name for sk in sketches]
        klist = list(exp["klist"])
        j = np.asarray(query_db(sketches, None, klist, self_mode=True,
                                jaccard=True, random_correct=False,
                                use_pallas=False))
        d = np.asarray(query_db(sketches, None, klist, self_mode=True,
                                random_correct=False, use_pallas=False))
        rows = {(p["a"], p["b"]): p for p in exp["pairs"]}
        for row, (a, b) in enumerate(iter_dist_rows(names, names)):
            want = rows[(a, b)]
            wj = np.array([want["jaccard"][str(k)] for k in klist])
            if not np.allclose(j[row], wj, rtol=1e-6, atol=1e-9):
                failures.append(f"{label}: jaccard drift on ({a},{b})")
            if not np.allclose(d[row], [want["core"], want["accessory"]],
                               rtol=1e-5, atol=1e-8):
                failures.append(f"{label}: core/acc drift on ({a},{b})")
    return failures


def check_pp_sketchlib(exp):
    """Bit-exactness vs the reference implementation, when installed."""
    try:
        import pp_sketchlib  # noqa: F401
    except ImportError:
        return None  # unavailable -> skipped, not failed

    import tempfile

    import h5py

    failures = []
    tmp = tempfile.mkdtemp(prefix="ppsk_conformance_")
    names, files = [], []
    for name, fl in sorted(exp["inputs"].items()):
        names.append(name)
        files.append([os.path.join(HERE, f) for f in fl])
    db = os.path.join(tmp, "ref")
    # kwargs, mirroring the reference's own call sites
    # (PopPUNK/sketchlib.py:410-422) — positional order there is easy to
    # get wrong (use_rc sits between calc_random and min_count). The
    # fixtures were generated with use_rc=True, min_count on the read
    # set, count-min (exact=False) filtering.
    pp_sketchlib.constructDatabase(
        db_name=db, samples=names, files=files, klist=list(exp["klist"]),
        sketch_size=int(exp["sketchsize64"] * 64), codon_phased=False,
        calc_random=False, use_rc=True, min_count=int(exp["min_count"]),
        exact=False, num_threads=1)
    with h5py.File(db + ".h5", "r") as h5:
        for name in names:
            grp = h5["sketches"][name]
            for k_str, digest in exp["sketches"][name][
                    "usig_sha256"].items():
                got = hashlib.sha256(
                    np.asarray(grp[k_str], dtype=np.uint64)
                    .tobytes()).hexdigest()
                if got != digest:
                    failures.append(
                        f"pp-sketchlib: {name} k={k_str} sketch differs")
    # raw jaccards (random_correct=False, jaccard=True) — the fixtures
    # store correction-free per-k values; rows follow iterDistRows
    # self-mode order, the same convention the fixture keys use
    from poppunk_tpu.pairs import iter_dist_rows

    jac = pp_sketchlib.queryDatabase(
        ref_db_name=db, query_db_name=db, rList=names, qList=names,
        klist=list(exp["klist"]), random_correct=False, jaccard=True,
        num_threads=1)
    rows = {(p["a"], p["b"]): p for p in exp["pairs"]}
    for row, (a, b) in enumerate(iter_dist_rows(names, names)):
        want = rows[(a, b)]
        wj = np.array([want["jaccard"][str(k)] for k in exp["klist"]])
        if not np.allclose(np.asarray(jac)[row], wj, rtol=1e-5):
            failures.append(
                f"pp-sketchlib: jaccard differs on ({a},{b})")
    return failures


def main():
    import jax

    from poppunk_tpu import configure_jax_cache

    # host-path validation: never touch (or contend for) the card
    jax.config.update("jax_platforms", "cpu")
    configure_jax_cache()
    exp = load_expected()
    failures = check_ours(exp)
    pp = check_pp_sketchlib(exp)
    if pp is None:
        sys.stderr.write("pp_sketchlib not importable: cross-check "
                         "SKIPPED (pipeline self-check still ran)\n")
    else:
        failures += pp
        sys.stderr.write("pp_sketchlib cross-check RAN\n")
    if failures:
        for f in failures:
            sys.stderr.write("FAIL: " + f + "\n")
        sys.exit(1)
    print("conformance: all checks passed")


if __name__ == "__main__":
    main()
