"""Build the port's CUDA kernels at first use and load them through ctypes.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in ``ops/_build/`` (listed in
``.gitignore``), named by a hash of the sources, so an edited source
rebuilds and an unchanged one is reused. A failed build raises: nothing
falls back to a plain version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _paths(name):
    """(source, library, log) paths of kernel ``name``; the library name
    carries a hash of the source and the shared header."""
    src = os.path.join(_CSRC, name + ".cu")
    h = hashlib.sha256()
    for p in (src, os.path.join(_CSRC, "common.cuh")):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}-{h.hexdigest()[:16]}"
    return src, os.path.join(BUILD_DIR, stem + ".so"), os.path.join(BUILD_DIR, stem + ".log")


def _start(name):
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, src]
    return name, lib, log, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)


def _finish(job):
    name, lib, log, tmp, proc = job
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all(names):
    """Compile every kernel in ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns {name: ptxas log}."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for job in jobs:
            if job[4].poll() is None:
                job[4].kill()
                job[4].wait()
    logs = {}
    for n in names:
        with open(_paths(n)[2]) as f:
            logs[n] = f.read()
    return logs


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_paths(name)[1])
        lib.ds_error_string.argtypes = [ctypes.c_int]
        lib.ds_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib, rc, what):
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.ds_error_string(rc).decode()})")


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
