"""Generate the pp-sketchlib conformance fixture set (run once; outputs
are committed).

Writes deterministic FASTA/FASTQ inputs and ``expected.json`` holding,
at the reference's production sketch geometry (k=13..28 step 3,
sketchsize64=156, bbits=14 — /root/reference/test/json_sketch.txt and
PopPUNK/sketchlib.py:348-434):

- per-sample, per-k sha256 of the packed sketch planes (usigs) — the
  bit-exact quantity a pp-sketchlib cross-check must reproduce;
- per-pair raw Jaccard at every k and the fitted core/accessory
  distances (random_correct=False so the numbers are correction-free).

``validate.py`` replays the pipeline against this file every run and —
when a pp_sketchlib wheel is importable — cross-validates bit-exactness
against the reference implementation itself
(PopPUNK/sketchlib.py:635-670).
"""

import gzip
import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KLIST = (13, 16, 19, 22, 25, 28)
SS64 = 156
BBITS = 14


def write_inputs():
    rng = np.random.default_rng(0xC0FFEE)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    inputs = {}

    # two related assemblies: asm_b is asm_a with 1% substitutions, so
    # the pair has a realistic non-trivial Jaccard at every k
    glen = 150_000
    g = bases[rng.integers(0, 4, glen)]
    for name, seq in (("asm_a", g), ("asm_b", _mutate(rng, g, 0.01, bases))):
        path = os.path.join(HERE, f"{name}.fa.gz")
        lines = [seq[s:s + 70].tobytes() for s in range(0, glen, 70)]
        payload = b">%b\n" % name.encode() + b"\n".join(lines) + b"\n"
        with open(path, "wb") as raw:
            # fixed mtime + no filename -> byte-reproducible archive
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as fh:
                fh.write(payload)
        inputs[name] = [os.path.basename(path)]

    # a read set over a third genome: exercises the FASTQ path
    # (count-min multiplicity filter, min_count=2) end to end
    rlen, cov, rglen = 100, 8, 50_000
    g3 = bases[rng.integers(0, 4, rglen)]
    starts = rng.integers(0, rglen - rlen, rglen * cov // rlen)
    qual = b"I" * rlen
    path = os.path.join(HERE, "reads_c.fastq.gz")
    chunks = []
    for i, s in enumerate(starts):
        chunks.append(b"@r%d\n%b\n+\n%b\n" % (i, g3[s:s + rlen].tobytes(),
                                              qual))
    with open(path, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as fh:
            fh.write(b"".join(chunks))
    inputs["reads_c"] = [os.path.basename(path)]
    return inputs


def _mutate(rng, g, rate, bases):
    out = g.copy()
    pos = np.flatnonzero(rng.random(g.shape[0]) < rate)
    out[pos] = bases[(np.searchsorted(bases, out[pos]) +
                      rng.integers(1, 4, pos.shape[0])) % 4]
    return out


def main():
    import jax

    from poppunk_tpu import configure_jax_cache

    # host-path validation: never touch (or contend for) the card
    jax.config.update("jax_platforms", "cpu")
    configure_jax_cache()
    from poppunk_tpu.ops.distances import query_db
    from poppunk_tpu.sketch.minhash import SketchParams, sketch_sequence
    from poppunk_tpu.sketch.reader import read_sequence_input
    from poppunk_tpu.pairs import iter_dist_rows

    inputs = write_inputs()
    params = SketchParams(klist=KLIST, sketchsize64=SS64, bbits=BBITS,
                          use_rc=True, min_count=2)
    sketches = []
    expected = {"klist": list(KLIST), "sketchsize64": SS64, "bbits": BBITS,
                "min_count": 2, "inputs": inputs, "sketches": {},
                "pairs": []}
    for name, files in inputs.items():
        paths = [os.path.join(HERE, f) for f in files]
        codes, length, missing, is_reads = read_sequence_input(paths)
        sk = sketch_sequence(name, codes, params, length=length,
                             missing_bases=missing, reads=is_reads)
        sketches.append(sk)
        expected["sketches"][name] = {
            "length": int(sk.length),
            "densified": bool(sk.densified),
            "usig_sha256": {str(k): hashlib.sha256(sk.usigs[k].tobytes())
                            .hexdigest() for k in KLIST},
        }

    names = [sk.name for sk in sketches]
    j = np.asarray(query_db(sketches, None, list(KLIST), self_mode=True,
                            jaccard=True, random_correct=False,
                            use_pallas=False))
    d = np.asarray(query_db(sketches, None, list(KLIST), self_mode=True,
                            random_correct=False, use_pallas=False))
    for row, (a, b) in enumerate(iter_dist_rows(names, names)):
        expected["pairs"].append({
            "a": a, "b": b,
            "jaccard": {str(k): float(j[row, ki])
                        for ki, k in enumerate(KLIST)},
            "core": float(d[row, 0]), "accessory": float(d[row, 1]),
        })

    out = os.path.join(HERE, "expected.json")
    with open(out, "w") as fh:
        json.dump(expected, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
