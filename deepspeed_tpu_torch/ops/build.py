"""Build the port's CUDA kernels at first use and load them through ctypes.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in ``ops/_build/`` (listed in
``.gitignore``), named by a hash of the source and of every header it
includes from ``csrc/`` (followed through nested includes), so an edit to a
source or to a header it shares rebuilds every library that uses it, and an
unchanged one is reused. A failed build raises: nothing
falls back to a plain version.

The host code of the offload tiers (``csrc/cpu_adam.c``, ``csrc/aio.c``)
builds the same way with the host C compiler (``$CC``, default ``cc``)
through :func:`load_host`, named by a hash of the source, the compiler and
its flags; a failed build raises with the compiler's output.

Threads may launch kernels at once (the serving gateway runs a pump thread
per replica), so a library is built, loaded and bound at most once: under
one lock, through :func:`bind` in the wrappers.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}
_loaded_host = {}
# one build at a time in a process: two threads building one library would
# share its temporary file
lock = threading.RLock()


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name):
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly or
    through another header, in the order first reached."""
    todo, seen = [os.path.join(_CSRC, name + ".cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep):  # a system header is found by nvcc, not here
                todo.append(os.path.normpath(dep))
    return seen


def _paths(name):
    """(source, library, log) paths of kernel ``name``; the library name
    carries a hash of the source and of every header it includes."""
    src = os.path.join(_CSRC, name + ".cu")
    h = hashlib.sha256()
    for p in sources(name):
        h.update(os.path.basename(p).encode())
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
    process per source, all started together. A name given twice (two
    kernels of one source) builds once. Returns {name: ptxas log}."""
    names = list(dict.fromkeys(names))
    with lock:
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
        with lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(_paths(name)[1])
                lib.ds_error_string.argtypes = [ctypes.c_int]
                lib.ds_error_string.restype = ctypes.c_char_p
                _loaded[name] = lib
    return lib


def bind(cache, name, setup):
    """``cache[name]``: kernel ``name``'s library (:func:`load`) with its
    launch signatures set by ``setup(lib)``, made once across threads."""
    lib = cache.get(name)
    if lib is None:
        with lock:
            lib = cache.get(name)
            if lib is None:
                lib = load(name)
                setup(lib)
                cache[name] = lib
    return lib


def check(lib, rc, what):
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.ds_error_string(rc).decode()})")


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def _host_paths(name, flags):
    """(source, library, command prefix) of host library ``name``; the
    library name carries a hash of the source, the compiler and its flags."""
    src = os.path.join(_CSRC, name + ".c")
    cmd = [os.environ.get("CC", "cc"), *flags, "-shared", "-fPIC"]
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-host-{h.hexdigest()[:16]}.so"), cmd


def load_host(name, flags, libs=()):
    """The ctypes library of ``csrc/<name>.c``, built with the host C
    compiler on first use. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    src, lib, cmd = _host_paths(name, flags)
    with lock:
        return _load_host(name, src, lib, cmd, libs)


def _load_host(name, src, lib, cmd, libs):
    if lib in _loaded_host:
        return _loaded_host[lib]
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([*cmd, src, "-o", tmp, *libs], capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise RuntimeError(f"building {name}.c: cannot run the C compiler {cmd[0]!r}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed to build {name}.c (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    _loaded_host[lib] = ctypes.CDLL(lib)
    return _loaded_host[lib]
