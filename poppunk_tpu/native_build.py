"""Builds of the native libraries (native/*.cpp), one per host CPU.

The libraries are compiled with ``-march=native``, so a build is only valid
on a CPU with the same instruction set. Each build goes into
``native/build/<host key>/``, keyed on the machine type and the CPU's model
and feature flags, and is rebuilt when older than its source.
"""

import hashlib
import os
import platform
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


def host_key():
    """A short digest of what -march=native depends on."""
    fields = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    fields.append(line.strip())
                if len(fields) >= 3:
                    break
    except OSError:
        fields.append(platform.processor())
    return hashlib.sha1("\n".join(fields).encode()).hexdigest()[:12]


def native_lib(name, openmp_optional=False):
    """Path of ``lib<name>.so`` built from ``native/<name>.cpp`` for this
    host, building it first if missing or stale. Raises on a failed build.

    With ``openmp_optional``, a toolchain without OpenMP gets the serial
    build."""
    src = os.path.join(NATIVE_DIR, name + ".cpp")
    out_dir = os.path.join(NATIVE_DIR, "build", host_key())
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.isfile(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target, then rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        if not openmp_optional:
            raise
        cmd.remove("-fopenmp")
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib
