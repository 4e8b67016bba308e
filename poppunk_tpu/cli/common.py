"""Shared CLI helpers: QC dict assembly, distance defaults, output setup."""

import os
import sys

from ..qc import DEFAULT_QC


def setup_output(output, overwrite=False):
    """Create the output directory (reference setupDBFuncs/createDatabaseDir
    convention: outputs live in a directory named by the prefix)."""
    if output is None:
        sys.stderr.write("--output required\n")
        sys.exit(1)
    output = output.rstrip("/")
    if os.path.isfile(output):
        sys.stderr.write(output + " exists as a file, cannot use as output\n")
        sys.exit(1)
    os.makedirs(output, exist_ok=True)
    return output


def file_base(prefix):
    return os.path.join(prefix, os.path.basename(prefix))


def default_dists(ref_db):
    return file_base(ref_db) + ".dists"


def qc_dict_from_args(args, run_qc=True):
    """Assemble the QC option dict (reference __main__.py:421-434)."""
    qc = dict(DEFAULT_QC)
    qc["run_qc"] = run_qc
    for key in ("length_sigma", "prop_n", "upper_n", "max_pi_dist",
                "max_a_dist", "x", "r"):
        if hasattr(args, key) and getattr(args, key) is not None:
            qc[key] = getattr(args, key)
    if getattr(args, "max_zero_dist", None) is not None:
        qc["prop_zero"] = args.max_zero_dist
    if getattr(args, "length_range", None):
        lr = args.length_range
        if isinstance(lr, str):
            lr = [int(x) for x in lr.split(",")]
        qc["length_range"] = lr
    if getattr(args, "retain_failures", False):
        qc["retain_failures"] = True
    if getattr(args, "qc_keep", False):
        qc["no_remove"] = True
    if getattr(args, "max_merge", None) is not None:
        qc["max_merge"] = args.max_merge
    if getattr(args, "betweenness", False):
        qc["betweenness"] = True
    if getattr(args, "type_isolate", None) is not None:
        qc["type_isolate"] = args.type_isolate
    return qc


_ACCEL_FLAG_DEFS = {
    "gpu-sketch": ("--gpu-sketch", dict(action="store_true")),
    "gpu-dist": ("--gpu-dist", dict(action="store_true")),
    "gpu-model": ("--gpu-model", dict(action="store_true")),
    "gpu-graph": ("--gpu-graph", dict(action="store_true")),
    "use-gpu": ("--use-gpu", dict(action="store_true")),
    "deviceid": ("--deviceid", dict(type=int, default=0)),
    "device-id": ("--device-id", dict(type=int, default=0)),
}


def add_accel_compat_flags(parser, *names):
    """Register the reference's GPU-offload flags as accepted no-ops.

    The reference gates CUDA offload behind --gpu-sketch/--gpu-dist/
    --gpu-model/--gpu-graph/--use-gpu/--deviceid (PopPUNK/__main__.py:
    216-220, docs/gpu.rst). Here every compute stage already runs on
    JAX's default device, so existing scripts keep working: the flags
    parse, do nothing, and note_accel_compat_flags() says so on stderr."""
    group = parser.add_argument_group(
        "GPU options (compatibility; compute runs on JAX's default device)")
    for name in names:
        flag, kwargs = _ACCEL_FLAG_DEFS[name]
        group.add_argument(flag, help="Accepted for compatibility with "
                          "PopPUNK; ignored (device offload is automatic)",
                          **kwargs)


def note_accel_compat_flags(args):
    set_flags = [f"--{n}" for n in
                 ("gpu_sketch", "gpu_dist", "gpu_model", "gpu_graph",
                  "use_gpu")
                 if getattr(args, n, False)]
    if set_flags:
        sys.stderr.write(
            " ".join(set_flags).replace("_", "-")
            + ": compute runs on JAX's default devices automatically; "
            "GPU flags are accepted for compatibility and ignored\n")


def parse_kmers(min_k, max_k, k_step):
    if min_k >= max_k:
        sys.stderr.write("Minimum k-mer length must be smaller than maximum\n")
        sys.exit(1)
    if min_k < 3:
        sys.stderr.write("Minimum k-mer length must be at least 3\n")
        sys.exit(1)
    return list(range(min_k, max_k + 1, k_step))
