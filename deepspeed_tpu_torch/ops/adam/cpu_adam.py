"""Host (CPU) Adam/AdamW and Adagrad over CPU torch tensors.

Port of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (the reference's
``DeepSpeedCPUAdam``, ``deepspeed/ops/adam/cpu_adam.py:13`` over
``csrc/adam/cpu_adam.cpp``): the ZeRO-Offload optimizer step runs on the
host against optimizer state in host memory. The native code
(``ops/csrc/cpu_adam.c``, a copy of the JAX package's) builds at first use
with ``cc -O3 -march=native`` into ``ops/_build/``
(``ops/build.py::load_host``) and is called through ctypes, which releases
the interpreter lock. The JAX package builds it with ``-fopenmp``; a host
compiler without OpenMP (the H100 machine's has no ``libgomp``) refuses
that, so here a step splits its tensors into ``SPLIT``-element pieces that
:data:`THREADS` pool threads step at once (elementwise, so the bits do not
depend on the split). A failed build raises with the compiler's output:
there is no fallback.

Tensors are contiguous CPU tensors: parameters and moments fp32, gradients
fp32 or bf16 (a ``torch.bfloat16`` tensor, read through its bits); a fp16
gradient is cast to fp32 first. :func:`f32_to_bf16` rounds to nearest even,
bitwise ``.to(torch.bfloat16)`` of a contiguous tensor (NaN included: 0xFFFF,
as torch's vectorized CPU cast writes it). The ``*_plain`` functions
are the same math in plain torch ops, for the tests only.
"""

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import build

SOURCE = "cpu_adam"
FLAGS = ("-O3", "-march=native")
THREADS = max(1, min(16, os.cpu_count() or 1))
SPLIT = 1 << 20  # elements a piece

_lib = None
_pool = ThreadPoolExecutor(max_workers=THREADS, thread_name_prefix="cpu-adam")


def _pieces(n):
    """[(start, stop)] covering n elements: one piece below 2 SPLIT, else
    about THREADS pieces of at least SPLIT."""
    if n < 2 * SPLIT or THREADS == 1:
        return [(0, n)]
    size = max(SPLIT, -(-n // THREADS))
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def _run(fn, n, args_at):
    """``fn(*args_at(a, b))`` over the pieces of n elements, in parallel."""
    pieces = _pieces(n)
    if len(pieces) == 1:
        fn(*args_at(0, n))
        return
    for f in [_pool.submit(fn, *args_at(a, b)) for a, b in pieces]:
        f.result()


def load_library():
    """The native library, built on first use (raises on a failed build)."""
    global _lib
    if _lib is None:
        lib = build.load_host(SOURCE, FLAGS, ("-lm", ))
        vp, i64, f32, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
        step = [vp, vp, vp, vp, i64, f32, f32, f32, f32, f32, i64, f32, cint]
        lib.ds_adamw_step.argtypes = step
        lib.ds_adamw_step.restype = None
        lib.ds_adamw_step_bf16g.argtypes = step
        lib.ds_adamw_step_bf16g.restype = None
        lib.ds_f32_to_bf16.argtypes = [vp, vp, i64]
        lib.ds_f32_to_bf16.restype = None
        lib.ds_adagrad_step.argtypes = [vp, vp, vp, i64, f32, f32, f32, f32]
        lib.ds_adagrad_step.restype = None
        _lib = lib
    return _lib


def cpu_adam_available():
    """True when the native library builds here (no fallback exists)."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def _ptr(t, dtype, what):
    if t.device.type != "cpu" or not t.is_contiguous() or t.dtype != dtype:
        raise ValueError(f"{what}: expected a contiguous CPU {dtype} tensor, got {t.dtype} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")
    return ctypes.c_void_p(t.data_ptr())


def _grad(grad):
    """(fp32 or bf16 contiguous gradient, is_bf16)."""
    if grad.dtype == torch.bfloat16:
        return grad.contiguous(), True
    return grad.contiguous().float(), False


class DeepSpeedCPUAdam:
    """Fused host AdamW (or Adam with ``adamw_mode=False``: the decay folded
    into the gradient) over a (param, m, v) triple of fp32 tensors."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, adamw_mode=True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self._lib = load_library()

    def step(self, p, m, v, grad, step, lr=None, grad_coef=1.0):
        """In-place update; ``step`` is 1-based, ``grad_coef`` multiplies the
        gradient first (unscale, averaging and clipping in one factor)."""
        lr = self.lr if lr is None else lr
        n = p.numel()
        if m.numel() != n or v.numel() != n or grad.numel() != n:
            raise ValueError(f"cpu_adam: sizes differ: p {n}, m {m.numel()}, v {v.numel()}, "
                             f"grad {grad.numel()}")
        g, bf16 = _grad(grad)
        fn = self._lib.ds_adamw_step_bf16g if bf16 else self._lib.ds_adamw_step
        ptrs = [_ptr(p, torch.float32, "p").value, _ptr(m, torch.float32, "m").value,
                _ptr(v, torch.float32, "v").value]
        gp, gs = g.data_ptr(), g.element_size()
        _run(fn, n, lambda a, b: (*(x + 4 * a for x in ptrs), gp + gs * a, b - a, lr, self.betas[0],
                                  self.betas[1], self.eps, self.weight_decay, int(step), grad_coef,
                                  int(self.adamw_mode)))


class DeepSpeedCPUAdagrad:
    """Host Adagrad (reference ``csrc/adagrad/cpu_adagrad.cpp``) over a
    (param, accumulator) pair of fp32 tensors."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self._lib = load_library()

    def step(self, p, acc, grad, lr=None, grad_coef=1.0):
        lr = self.lr if lr is None else lr
        g = grad.contiguous().float()
        ptrs = [_ptr(t, torch.float32, w).value for t, w in ((p, "p"), (acc, "acc"), (g, "grad"))]
        _run(self._lib.ds_adagrad_step, p.numel(),
             lambda a, b: (*(x + 4 * a for x in ptrs), b - a, lr, self.eps, self.weight_decay, grad_coef))


def f32_to_bf16(src, out=None):
    """fp32 -> bf16 on the host, round to nearest even (``out``: a
    contiguous CPU bf16 tensor of ``src``'s size, written in place)."""
    lib = load_library()
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16)
    if out.numel() != src.numel():
        raise ValueError(f"f32_to_bf16: sizes differ: {src.numel()} -> {out.numel()}")
    s, o = _ptr(src, torch.float32, "src").value, _ptr(out, torch.bfloat16, "out").value
    _run(lib.ds_f32_to_bf16, src.numel(), lambda a, b: (s + 4 * a, o + 2 * a, b - a))
    return out


# ---------------------------------------------------------------------------
# plain versions (tests only): the C code's order of operations in fp32


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_step_plain(p, m, v, grad, step, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                     grad_coef=1.0, adamw_mode=True):
    b1, b2 = _f32(betas[0]), _f32(betas[1])
    inv_bc1 = 1.0 / (1.0 - b1**step)
    inv_bc2 = 1.0 / (1.0 - b2**step)
    wd = _f32(weight_decay)
    g = grad.float() * _f32(grad_coef)
    if not adamw_mode and weight_decay:
        g = g + wd * p
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    upd = (m * inv_bc1) / (torch.sqrt(v * inv_bc2) + _f32(eps))
    if adamw_mode and weight_decay:
        upd = upd + wd * p
    p.sub_(_f32(lr) * upd)


@torch.no_grad()
def adagrad_step_plain(p, acc, grad, lr, eps=1e-10, weight_decay=0.0, grad_coef=1.0):
    g = grad.float() * _f32(grad_coef)
    if weight_decay:
        g = g + _f32(weight_decay) * p
    acc.add_(g * g)
    p.sub_(_f32(lr) * g / (torch.sqrt(acc) + _f32(eps)))


def f32_to_bf16_plain(src):
    return src.to(torch.bfloat16)
