#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. environment: torch/CUDA versions and the card's name and power limit;
2. kernels: builds the CUDA kernels from ``deepspeed_tpu_torch/ops/csrc``
   (one nvcc per source, started together), compares each of the seven
   with its plain PyTorch version on the card at the main paths' shapes
   (the flash forward at the serving and the training shapes; the
   backward kernels on the plain forward's residuals),
   and times the kernel, the plain version and one PyTorch library call for
   the same function (for the two fused decode-layer kernels, which no
   single call computes, the chain of library calls instead; for the two
   flash backward kernels, scaled_dot_product_attention's forward and
   backward, beside the port's forward and backward), beside the datasheet
   bound (3.35 TB/s, 989 TFLOP/s bf16); the backward kernels must also give
   bitwise-equal outputs on two calls;
3. the main path: gpt2-large (36 layers, full width, random weights from a
   seed) served through ``init_inference`` with the default int8
   kernel-injected config, so decode steps take the fused decode layer;
   8 prompts of 128 tokens, 128 new tokens, greedy (twice: the streams
   must be identical) and sampled. Every kernel's launch count over the
   greedy run must equal the path's: fused_qkv_ln = fused_out_mlp =
   decode = 36*127, flash 36, quant_matmul (4*36+1) + 127 (the prefill,
   then the int8 head of every decode step). The prefill logits and the
   fused decode steps' logits of the kernel path are compared with the
   plain versions on the card, and the steady decode rate is measured and
   profiled;
4. the per-projection path: the same model and weights with
   ``fused_decode_block: False`` (launch counts quant_matmul (4*36+1)*128,
   flash 36, decode 36*127), its steady decode rate and profile beside the
   fused path's;
5. llama3-8b at full width, depth cut to 2 layers (set-up time), fused, so
   RoPE, RMSNorm, SwiGLU, GQA g=4 and the head-dim-128 kernels run end to
   end;
6. training, the second main path: gpt2-large at full width and depth
   (random weights from the config seed) through ``initialize`` →
   ``train_batch`` with ``bench.py``'s config (micro batch 4, seq 1024,
   AdamW lr 3e-4 wd 0.01, bf16, clipping 1.0) on one random batch: 3
   warm-up steps, 10 timed steps; every loss finite and the last below the
   first, launches per step flash forward = dq = dk/dv = 36; step time,
   tokens/s and MFU by ``bench.py::_mfu``'s formula, a profile of two
   steps (device busy share, top device ops) and the peak device memory;
7. one micro-step at gpt2-large width, depth cut to 4 layers, through the
   kernels and through ``impl="plain"`` on the card: the loss, the global
   gradient norm and each head's slice of every attention projection's
   weight gradient within the ``PARITY_*`` limits; then the same with each
   of ``PLANTED_FAULTS`` (dk of one head, dq of one head's last tile,
   zeroed in one layer), which the check must catch;
8. llama3-8b training at full width, depth cut to 2 layers, micro batch
   1, seq 2048: the same kernel-vs-plain micro-step check, then 3 steps:
   GQA g=4, D=128, RoPE, RMSNorm and SwiGLU through the backward kernels;
   finite losses and exact launch counts.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
``deepspeed_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
BF16_FLOP_PER_S = 989e12   # H100 SXM datasheet, dense
SEED = 0
SLEEP_CYCLES = 20_000_000  # ~10 ms at H100 clocks: covers the host time of any timed call


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, flush, iters=10):
    """Median device time of one call of ``fn`` (CUDA events), with the
    50 MB L2 flushed before each call as the main path finds it cold. A
    sleep kernel ahead of the start event keeps the device busy while the
    host enqueues ``fn``, so the events time the device work and not the
    host's launch latency."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def qmm_cases(torch, gen, dev):
    """gpt2-large's projections (int8, group 128) and int8 head, at decode
    (M = B = 8) and prefill (M = B*P = 1024)."""
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    shapes = [("qkv", 1280, 3840), ("o", 1280, 1280), ("up", 1280, 5120), ("down", 5120, 1280),
              ("head", 1280, 51200)]
    for M in (8, 1024):
        for proj, K, N in shapes:
            G = K // 128
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            qw = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
            sc = torch.rand((G, N), generator=gen, device=dev) * 0.01 + 1e-4
            w_deq = (qw.float().reshape(G, K // G, N) * sc[:, None, :]).reshape(K, N).to(torch.bfloat16)
            nbytes = M * K * 2 + K * N + G * N * 4 + M * N * 2
            yield (f"{'decode' if M == 8 else 'prefill'} {proj} M={M} K={K} N={N}",
                   lambda x=x, qw=qw, sc=sc: quant_matmul(x, qw, sc),
                   lambda x=x, qw=qw, sc=sc: quant_matmul_plain(x, qw, sc),
                   lambda x=x, w=w_deq: torch.matmul(x, w),
                   nbytes, 2 * M * K * N)


# the training paths' attention: gpt2-large (B=4, H=20, T=1024, D=64) and
# llama3-8b (B=1, H=32/8, T=2048, D=128), causal
BWD_SHAPES = ((4, 20, 20, 1024, 64), (1, 32, 8, 2048, 128))


def flash_cases(torch, gen, dev):
    """The serving paths' prefill, gpt2-large (B=8, H=20, T=128, D=64) and a
    llama3-8b shape (H=32, Hkv=8, T=512, D=128), and the training paths'
    shapes (``BWD_SHAPES``), where the online softmax spans 16 to 32 KV
    tiles."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain, \
        flash_attention_with_lse
    for B, H, Hkv, T, D in ((8, 20, 20, 128, 64), (4, 32, 8, 512, 128)) + BWD_SHAPES:
        q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
        pairs = B * H * T * (T + 1) // 2  # causal (query, key) pairs
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + B * H * T * 4
        yield (f"causal B={B} H={H} Hkv={Hkv} T={T} D={D}",
               lambda q=q, k=k, v=v: flash_attention_with_lse(q, k, v, causal=True),
               lambda q=q, k=k, v=v: flash_attention_plain(q, k, v, causal=True),
               lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=H != Hkv),
               nbytes, 4 * D * pairs)


def _bwd_inputs(torch, gen, dev, B, H, Hkv, T, D):
    """Random q, k, v, dO and the residuals out, lse of the plain forward, so
    that the backward kernels' check does not rest on the forward kernel's
    (which ``flash_cases`` checks at these shapes)."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain
    q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention_plain(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, out, lse, delta


def _fwd_bwd(torch, fn, q, k, v, do):
    """Forward and backward of one attention call, through autograd."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, do)


def bwd_cases(torch, gen, dev, which):
    """Flash backward kernel ``which`` ("dq" or "dkv") at the training
    shapes. Plain: the whole plain backward (it computes dq, dk and dv
    together). Library: scaled_dot_product_attention forward + backward;
    ``port_fwd_bwd_ms`` is the port's forward + backward kernels through
    autograd, the like-for-like yardstick of it."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (_group_sum, flash_attention,
                                                         flash_attention_bwd_plain, flash_bwd_dkv,
                                                         flash_bwd_dq)
    for B, H, Hkv, T, D in BWD_SHAPES:
        q, k, v, do, out, lse, delta = _bwd_inputs(torch, gen, dev, B, H, Hkv, T, D)
        pairs = B * H * T * (T + 1) // 2  # causal (query, key) pairs, per query head
        in_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * B * H * T * 4
        if which == "dq":
            kern = lambda q=q, k=k, v=v, do=do, lse=lse, d=delta: flash_bwd_dq(q, k, v, do, lse, d)
            plain = lambda a=(q, k, v, out, lse, do): flash_attention_bwd_plain(*a)[0]
            nbytes, flops = in_bytes + q.numel() * 2, 6 * D * pairs
        else:
            kern = lambda q=q, k=k, v=v, do=do, lse=lse, d=delta, n=Hkv: tuple(
                _group_sum(x, n) for x in flash_bwd_dkv(q, k, v, do, lse, d))
            plain = lambda a=(q, k, v, out, lse, do): flash_attention_bwd_plain(*a)[1:]
            nbytes, flops = in_bytes + 2 * k.numel() * 2, 8 * D * pairs
        gqa = H != Hkv
        library = lambda q=q, k=k, v=v, do=do, gqa=gqa: _fwd_bwd(
            torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                                  enable_gqa=gqa), q, k, v, do)
        port = lambda q=q, k=k, v=v, do=do: _fwd_bwd(
            torch, lambda a, b, c: flash_attention(a, b, c, causal=True), q, k, v, do)
        yield (f"causal B={B} H={H} Hkv={Hkv} T={T} D={D}", kern, plain, library, nbytes, flops,
               {"port_fwd_bwd_ms": port})


def dq_cases(torch, gen, dev):
    return bwd_cases(torch, gen, dev, "dq")


def dkv_cases(torch, gen, dev):
    return bwd_cases(torch, gen, dev, "dkv")


def decode_cases(torch, gen, dev):
    """gpt2-large decode (B=8, H=20, S=256, D=64, per-row ends 129..255,
    left-pad starts) and a GQA g=4 llama shape (H=32, kv=8, D=128)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    for B, H, nkv, S, D in ((8, 20, 20, 256, 64), (4, 32, 8, 256, 128)):
        q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((B, nkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((B, nkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        ends = torch.linspace(129, 255, B, device=dev).round().to(torch.int32)
        starts = torch.tensor([0, 0, 5, 0, 17, 0, 0, 40][:B], device=dev, dtype=torch.int32)
        live = int((ends - starts).sum())
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])
        mask = mask[:, None, None, :]
        nbytes = 2 * q.numel() * 2 + live * nkv * D * 2 * 2 + 2 * B * 4
        yield (f"B={B} H={H} kv={nkv} S={S} D={D} ends {int(ends.min())}..{int(ends.max())}",
               lambda q=q, kc=kc, vc=vc, s=starts, e=ends: decode_attention(q, kc, vc, s, e),
               lambda q=q, kc=kc, vc=vc, s=starts, e=ends: decode_attention_plain(q, kc, vc, s, e),
               lambda q=q, kc=kc, vc=vc, m=mask: F.scaled_dot_product_attention(
                   q[:, :, None], kc, vc, attn_mask=m, enable_gqa=H != nkv),
               nbytes, 4 * (H // nkv) * D * live * nkv)


def _dequant(torch, qw, sc):
    K, N = qw.shape
    G = sc.shape[0]
    return (qw.float().reshape(G, K // G, N) * sc[:, None, :]).reshape(K, N).to(torch.bfloat16)


def _proj(torch, gen, dev, K, N):
    """An int8 projection as quantize_params leaves it: (K, N) int8, group
    128 scales, fp32 bias."""
    G = K // 128
    return (torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8),
            torch.rand((G, N), generator=gen, device=dev) * 0.01 + 1e-4,
            torch.randn((N, ), generator=gen, device=dev) * 0.1)


def _proj_bytes(p):
    return sum(t.numel() * t.element_size() for t in p)


def _norm_rows(torch, gen, dev, H, norm):
    n = torch.randn((4, H), generator=gen, device=dev) * 0.1
    n[0] += 1.0
    n[2] += 1.0
    if norm == "rmsnorm":  # zero bias rows, as fused_decode_operands gives them
        n[1] = 0.0
        n[3] = 0.0
    return n


def _lib_norm(F, torch, x, norms, row, norm):
    H = x.shape[1]
    if norm == "rmsnorm":
        return F.rms_norm(x.float(), (H, ), norms[row], 1e-5).to(torch.bfloat16)
    return F.layer_norm(x.float(), (H, ), norms[row], norms[row + 1], 1e-5).to(torch.bfloat16)


# the main path's decode layers: (label, B, H, nh, nkv, hd, F, activation, norm, rope)
LAYER_SHAPES = [("gpt2-large", 8, 1280, 20, 20, 64, 5120, "gelu", "layernorm", False),
                ("llama3-8b", 4, 4096, 32, 8, 128, 14336, "swiglu", "rmsnorm", True)]


def qkv_ln_cases(torch, gen, dev):
    """Kernel A at gpt2-large's decode layer (B=8, H=1280, 20 heads of 64,
    layernorm) and llama3-8b's (B=4, H=4096, 32 q and 8 kv heads of 128,
    rmsnorm, RoPE). Library: layer_norm/rms_norm + torch.matmul on the
    dequantized bf16 weight + bias (+ RoPE in torch ops), a chain of calls."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_block import fused_qkv_ln, fused_qkv_ln_plain
    for label, B, H, nh, nkv, hd, _, _, norm, rope in LAYER_SHAPES:
        N = (nh + 2 * nkv) * hd
        x = (torch.randn((B, H), generator=gen, device=dev) * 2).to(torch.bfloat16)
        norms = _norm_rows(torch, gen, dev, H, norm)
        qkv = _proj(torch, gen, dev, H, N)
        rope_op = None
        nbytes = x.numel() * 2 + 2 * H * 4 + _proj_bytes(qkv) + B * N * 2
        if rope:
            ang = torch.rand((B, hd // 2), generator=gen, device=dev) * 6.0
            rope_op = (torch.sin(ang), torch.cos(ang), nh + nkv, hd)
            nbytes += 2 * B * (hd // 2) * 4
        w16, b16 = _dequant(torch, qkv[0], qkv[1]), qkv[2].to(torch.bfloat16)

        def chain(x=x, norms=norms, w16=w16, b16=b16, rope_op=rope_op, norm=norm):
            y = torch.matmul(_lib_norm(F, torch, x, norms, 0, norm), w16) + b16
            if rope_op is None:
                return y
            sin, cos, rh, hd = rope_op
            a, b = y[:, :rh * hd].unflatten(1, (rh, hd)).chunk(2, dim=-1)
            sin, cos = sin[:, None].to(y.dtype), cos[:, None].to(y.dtype)
            rot = torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(1)
            return torch.cat([rot, y[:, rh * hd:]], dim=1)

        yield (f"{label} B={B} H={H} N={N}{' rope' if rope else ''} {norm}",
               lambda x=x, n=norms, p=qkv, r=rope_op, nm=norm: fused_qkv_ln(x, n, p, norm=nm, rope=r),
               lambda x=x, n=norms, p=qkv, r=rope_op, nm=norm: fused_qkv_ln_plain(x, n, p, norm=nm,
                                                                                   rope=r),
               chain, nbytes, 2 * B * H * N)


def out_mlp_cases(torch, gen, dev):
    """Kernel C at gpt2-large's decode layer (B=8, H=1280, F=5120, gelu,
    layernorm) and llama3-8b's (B=4, H=4096, F=14336, swiglu, rmsnorm).
    Library: the chain torch.matmul + bias + residual, layer_norm/rms_norm,
    torch.matmul (x2 gated) + bias + activation, torch.matmul + bias +
    residual, on the dequantized bf16 weights."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_block import fused_out_mlp, fused_out_mlp_plain
    for label, B, H, nh, nkv, hd, F_, act, norm, _ in LAYER_SHAPES:
        Ko = nh * hd
        attn = torch.randn((B, Ko), generator=gen, device=dev).to(torch.bfloat16)
        x = (torch.randn((B, H), generator=gen, device=dev) * 4).to(torch.bfloat16)
        norms = _norm_rows(torch, gen, dev, H, norm)
        o, up, down = _proj(torch, gen, dev, Ko, H), _proj(torch, gen, dev, H, F_), \
            _proj(torch, gen, dev, F_, H)
        gate = _proj(torch, gen, dev, H, F_) if act in ("swiglu", "geglu") else None
        projs = [p for p in (o, up, gate, down) if p is not None]
        nbytes = (attn.numel() + 2 * x.numel()) * 2 + 2 * H * 4 + sum(map(_proj_bytes, projs))
        flops = 2 * B * sum(p[0].numel() for p in projs)
        w16 = [(_dequant(torch, p[0], p[1]), p[2].to(torch.bfloat16)) if p is not None else None
               for p in (o, up, gate, down)]

        def chain(attn=attn, x=x, norms=norms, w16=w16, act=act, norm=norm):
            (wo, bo), (wu, bu), g, (wd, bd) = w16
            r = torch.matmul(attn, wo) + bo + x
            h = _lib_norm(F, torch, r, norms, 2, norm)
            u = torch.matmul(h, wu) + bu
            if g is not None:
                u = F.silu(torch.matmul(h, g[0]) + g[1]) * u
            else:
                u = F.gelu(u, approximate="tanh")
            return r + torch.matmul(u, wd) + bd

        kw = dict(activation=act, norm=norm, gate=gate)
        yield (f"{label} B={B} H={H} Ko={Ko} F={F_} {act} {norm}",
               lambda a=attn, x=x, n=norms, o=o, u=up, d=down, kw=kw: fused_out_mlp(a, x, n, o, u, d,
                                                                                    **kw),
               lambda a=attn, x=x, n=norms, o=o, u=up, d=down, kw=kw: fused_out_mlp_plain(
                   a, x, n, o, u, d, **kw),
               chain, nbytes, flops)


KERNELS = [
    # name, source, TPU kernel it replaces (its pallas_call), case generator,
    # "call" when one PyTorch call computes the same function, else "chain"
    ("quant_matmul", "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
     "deepspeed_tpu/ops/pallas/quant_matmul.py:143", qmm_cases, "call"),
    ("flash_attention", "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:236", flash_cases, "call"),
    ("decode_attention", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198", decode_cases, "call"),
    ("fused_qkv_ln", "deepspeed_tpu_torch/ops/csrc/fused_qkv_ln.cu",
     "deepspeed_tpu/ops/pallas/decode_block.py:205", qkv_ln_cases, "chain"),
    ("fused_out_mlp", "deepspeed_tpu_torch/ops/csrc/fused_out_mlp.cu",
     "deepspeed_tpu/ops/pallas/decode_block.py:386", out_mlp_cases, "chain"),
    ("flash_bwd_dq", "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:298", dq_cases, "call"),
    ("flash_bwd_dkv", "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:315", dkv_cases, "call"),
]
# kernels whose two calls on the same inputs must agree bit for bit
DETERMINISTIC = ("flash_bwd_dq", "flash_bwd_dkv")


def kernel_phase(torch, dev):
    """Compare and time every kernel; returns {name: aggregate entry}."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    results = {}
    for name, source, replaces, cases, library_kind in KERNELS:
        agg = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": None, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0, "cases": []}
        if library_kind == "chain":  # no single PyTorch call: library_ms stays null
            agg["library_ms"], agg["library_chain_ms"] = None, 0.0
        for label, kern, plain, library, nbytes, flops, *extra in cases(torch, gen, dev):
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
            if name in DETERMINISTIC:
                again = kern()
                again = again if isinstance(again, tuple) else (again, )
                check(all(torch.equal(o, a) for (o, _), a in zip(pairs, again)),
                      f"{name} [{label}]: two calls on the same inputs differ")
            case_err, case_ref = 0.0, 0.0
            # outputs in bf16 (the working type): one bf16 ulp at the largest
            # magnitude, 2^-7 of max|plain|; the flash lse (fp32 on both
            # sides, online vs direct softmax) within 1e-3
            for i, (o, r) in enumerate(pairs):
                err = float((o.float() - r.float()).abs().max())
                ref_max = float(r.float().abs().max())
                tol = 1e-3 if o.dtype == torch.float32 else 2.0**-7 * ref_max
                check(err <= tol, f"{name} [{label}] output {i}: max abs err {err:.3e} > {tol:.3e}")
                check(bool(torch.isfinite(o.float()).all()), f"{name} [{label}] non-finite output")
                case_err, case_ref = max(case_err, err), max(case_ref, ref_max)
            agg["max_abs_err"] = max(agg["max_abs_err"], case_err)
            k_ms, p_ms, l_ms = cuda_ms(kern, flush), cuda_ms(plain, flush, 3), cuda_ms(library, flush)
            b_ms, b_by = bound_ms(nbytes, flops)
            extra_ms = {key: cuda_ms(fn, flush) for key, fn in (extra[0] if extra else {}).items()}
            log(f"kernel {name} [{label}]: {k_ms:.4f} ms (plain {p_ms:.4f}, library "
                f"{'chain ' if library_kind == 'chain' else ''}{l_ms:.4f}, bound {b_ms:.4f} by "
                f"{b_by}{''.join(f', {key} {v:.4f}' for key, v in extra_ms.items())}), "
                f"max abs err {case_err:.3e} (max |plain| {case_ref:.3e})")
            for key, v in extra_ms.items():
                agg[key] = agg.get(key, 0.0) + v
            agg["ms"] += k_ms
            agg["plain_ms"] += p_ms
            agg["library_chain_ms" if library_kind == "chain" else "library_ms"] += l_ms
            agg["bound_ms"] += b_ms
            agg["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
            agg["ops_ms"] += flops / BF16_FLOP_PER_S * 1e3
            agg["cases"].append({"case": label, "ms": k_ms, "plain_ms": p_ms,
                                 ("library_chain_ms" if library_kind == "chain" else "library_ms"): l_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": case_err,
                                 "max_abs_plain": case_ref, **extra_ms})
        agg["bound_by"] = "bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms") else "operations"
        results[name] = agg
    del flush
    return results


# ---------------------------------------------------------------------------
# phases 3-4: the main path


def counters():
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.decode_block import fused_out_mlp, fused_qkv_ln
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    return {"quant_matmul": quant_matmul, "flash_attention": flash_attention_fwd,
            "decode_attention": decode_attention, "fused_qkv_ln": fused_qkv_ln,
            "fused_out_mlp": fused_out_mlp, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def expected_counts(cfg, new_tokens, fused):
    """Launches of one generate of ``new_tokens`` (no eos). The prefill runs
    each layer's int8 projections (fused qkv, o, up, down, plus gate for a
    gated MLP), flash once per layer and the int8 head. Each of the
    new_tokens - 1 decode steps runs the decode kernel once per layer, and
    either kernel A and kernel C once per layer and the int8 head (fused),
    or every projection and the head again (per-projection)."""
    L, steps = cfg.num_layers, new_tokens - 1
    projections = 5 if cfg.activation in ("swiglu", "geglu") else 4
    per_forward = projections * L + 1
    return {"quant_matmul": per_forward + steps * (1 if fused else per_forward),
            "flash_attention": L, "decode_attention": L * steps,
            "fused_qkv_ln": L * steps if fused else 0, "fused_out_mlp": L * steps if fused else 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def expected_train_counts(cfg, steps, gas=1):
    """Launches of ``steps`` train steps of ``gas`` microbatches: one flash
    forward, one dq and one dk/dv per layer and microbatch, nothing else."""
    n = cfg.num_layers * gas * steps
    return {"quant_matmul": 0, "flash_attention": n, "decode_attention": 0, "fused_qkv_ln": 0,
            "fused_out_mlp": 0, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def check_tokens(out, B, n, vocab, what):
    check(len(out) == B, f"{what}: {len(out)} rows, expected {B}")
    for row in out:
        check(len(row) == n, f"{what}: row of {len(row)} tokens, expected {n}")
        check(bool(((row >= 0) & (row < vocab)).all()), f"{what}: token outside [0, {vocab})")


def prefill_logits_check(torch, eng, prompts, what):
    """Prefill logits of the kernel path against the plain versions on the
    card (same weights, same inputs). Tolerance: bf16 compute through every
    layer; relative L2 error of the logits within 5e-2."""
    B, P = prompts.shape
    ids = torch.as_tensor(prompts, device=eng.device).long()
    S = 256
    with torch.inference_mode():
        lk, _ = eng.module.apply_with_cache(eng.net, ids, eng.module.init_cache(B, S, device=eng.device), 0)
        lp, _ = eng.module.apply_with_cache(eng.net, ids, eng.module.init_cache(B, S, device=eng.device), 0,
                                            impl="plain")
    lk, lp = lk.float(), lp.float()
    rel = float((lk - lp).norm() / lp.norm())
    err = float((lk - lp).abs().max())
    agree = float((lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1)).float().mean())
    log(f"{what} prefill logits, kernels vs plain on the card: rel L2 {rel:.3e}, max abs {err:.3e} "
        f"(max |logit| {float(lp.abs().max()):.3e}), last-position argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(lk).all()), f"{what}: non-finite kernel-path logits")
    check(rel <= 5e-2, f"{what}: kernel-path logits differ from plain by rel L2 {rel:.3e} > 5e-2")


def fused_step_check(torch, eng, prompts, what, steps=4):
    """The engine's fused decode step with its kernels against the same step
    with their plain versions on the card: one prefill, two copies of the
    cache, ``steps`` steps both fed the kernel path's greedy tokens.
    Tolerance as the prefill check: relative L2 of the logits within 5e-2."""
    B, P = prompts.shape
    dev = eng.device
    layers, head = eng._fast_tree()
    starts = torch.zeros((B, ), dtype=torch.int32, device=dev)
    worst, agree = 0.0, []
    with torch.inference_mode():
        cache = eng.module.init_cache(B, 256, device=dev)
        logits, cache = eng.module.apply_with_cache(eng.net, torch.as_tensor(prompts, device=dev).long(),
                                                    cache, 0)
        plain_cache = tuple(tuple(c.clone() for c in comp) for comp in cache)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        for t in range(steps):
            pos_rows = torch.full((B, ), P + t, dtype=torch.long, device=dev)
            lk = eng._fused_step(layers, head, cache, tok, pos_rows, P + t, starts)
            lp = eng._fused_step(layers, head, plain_cache, tok, pos_rows, P + t, starts, impl="plain")
            check(bool(torch.isfinite(lk).all()), f"{what}: non-finite fused-step logits")
            worst = max(worst, float((lk - lp).norm() / lp.norm()))
            agree.append(float((lk.argmax(-1) == lp.argmax(-1)).float().mean()))
            tok = lk.argmax(-1).to(torch.int32)
    log(f"{what} fused decode steps, kernels vs plain on the card: worst rel L2 {worst:.3e} over "
        f"{steps} steps, argmax agreement {[round(a, 3) for a in agree]}")
    check(worst <= 5e-2, f"{what}: fused-step logits differ from plain by rel L2 {worst:.3e} > 5e-2")


def steady_step(torch, eng, prompts, what, card):
    """Steady decode step as bench.py measures it: two run lengths split the
    fixed cost (prefill, set-up) from the marginal decode step."""
    B, P = prompts.shape
    times = {}
    for new in (16, 144):
        eng.generate(prompts, max_new_tokens=new)
        trials = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            trials.append(time.perf_counter() - t)
        times[new] = min(trials)
    step_s = (times[144] - times[16]) / 128
    log(f"{what} int8 decode, B={B}, prompt {P}: t(16)={times[16]:.4f} s, t(144)={times[144]:.4f} s, "
        f"steady step {step_s * 1e3:.3f} ms = {B / step_s:.1f} tok/s on {card}")
    # a decode step reads every weight but the gathered embedding rows once,
    # and the live K/V window of every layer (mean position over the
    # differenced steps 16..144)
    mc = eng.model_config
    w_bytes = sum(t.numel() * t.element_size() for k, t in eng.params.items()
                  if not k.startswith(("embed.", "pos_embed")))
    kv_bytes = 2 * mc.num_layers * B * mc.kv_heads * mc.head_size * 2 * (P + 80)
    step_bound_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"{what} decode step bound: ({w_bytes} weight + {kv_bytes} KV bytes) / 3.35 TB/s = "
        f"{step_bound_ms:.4f} ms; measured step is {step_s * 1e3 / step_bound_ms:.1f}x it")
    return step_s


def gpt2_large_phase(torch, card, fused):
    """gpt2-large at full width and depth, int8, kernel injection. ``fused``:
    the default config (decode steps through the fused decode layer), the
    main path; else ``fused_decode_block: False`` (the per-projection
    path). Returns (launch counts of the greedy run, greedy rows)."""
    import numpy as np
    import deepspeed_tpu_torch
    B, P, NEW = 8, 128, 128
    what = "gpt2-large " + ("fused" if fused else "per-projection")
    config = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512}
    if not fused:
        config["fused_decode_block"] = False
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference("gpt2-large", config=config)
    log(f"{what} int8 engine built in {time.perf_counter() - t0:.1f} s "
        f"(random weights, seed 0; host-side quantize)")
    check(bool(eng._fused_decode_eligible()) == fused,
          f"{what}: fused decode gate {eng._fused_decode_eligible()!r}")
    vocab = eng.model_config.vocab_size
    prompts = np.random.default_rng(SEED).integers(0, vocab, (B, P)).astype(np.int32)
    eng.generate(prompts, max_new_tokens=8)  # first-use costs outside the counted run
    torch.cuda.synchronize()

    reset_counts()
    greedy = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(eng.model_config, NEW, fused)
    log(f"{what} greedy generate launches {counts}, expected {want}")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    check_tokens(greedy, B, NEW, vocab, f"{what} greedy")
    again = eng.generate(prompts, max_new_tokens=NEW)
    check(all(np.array_equal(a, b) for a, b in zip(greedy, again)),
          f"{what} greedy output differs between two runs")

    if fused:
        reset_counts()
        kw = dict(max_new_tokens=NEW, do_sample=True, temperature=0.8, top_k=50, top_p=0.95, seed=1)
        sampled = eng.generate(prompts, **kw)
        torch.cuda.synchronize()
        s_counts = read_counts()
        check(s_counts == want, f"{what} sampled launch counts {s_counts} != {want}")
        check_tokens(sampled, B, NEW, vocab, f"{what} sampled")
        check(all(np.array_equal(a, b) for a, b in zip(sampled, eng.generate(prompts, **kw))),
              f"{what} sampled output differs between two runs with one seed")
        log(f"{what} greedy row 0 starts {greedy[0][:8].tolist()}, sampled row 0 starts "
            f"{sampled[0][:8].tolist()}")
        prefill_logits_check(torch, eng, prompts, what)
        fused_step_check(torch, eng, prompts, what)

    step_s = steady_step(torch, eng, prompts, what, card)
    decode_profile(torch, eng, prompts, step_s * 1e3, what)
    del eng
    torch.cuda.empty_cache()
    return counts, greedy


# a CUPTI overhead record of launch back-pressure (the host waiting on a
# full launch queue), not device work
_NOT_DEVICE_WORK = ("Command Buffer Full", )


def device_profile(prof, steps):
    """(rows, busy ms per step) of a profile over ``steps`` steps. Rows are
    the device-side events only, (name, ms per step, calls per step): the
    row of a CPU op (an aten op, an autograd Function) carries the device
    time of the kernels it launched, so summing both would count that time
    twice. Busy time is the union of the device events' intervals."""
    from torch.autograd import DeviceType

    def on_device(e):
        return e.device_type == DeviceType.CUDA and not e.key.startswith(_NOT_DEVICE_WORK)

    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages() if on_device(e) and e.self_device_time_total > 0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith(_NOT_DEVICE_WORK))
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return rows, busy_us / 1e3 / steps


def decode_profile(torch, eng, prompts, step_ms, what, steps=8):
    """Where a steady decode step's time goes: device time by kernel
    (torch.profiler, CUPTI) over ``steps`` decode steps after a prefill, and
    the device's busy share of the wall time, both under the profiler and
    against ``step_ms``, the step measured without it. The steps are the
    engine's own: its fused step when the gate admits the config, else the
    per-projection forward."""
    from torch.profiler import ProfilerActivity, profile
    B, P = prompts.shape
    dev = eng.device
    ids = torch.as_tensor(prompts, device=dev).long()
    pos = torch.full((B, 1), P, dtype=torch.long, device=dev)
    fused = bool(eng._fused_decode_eligible())
    if fused:
        layers, head = eng._fast_tree()
        pads = torch.zeros((B, ), dtype=torch.long, device=dev)
        starts = pads.to(torch.int32)
    with torch.inference_mode():
        cache = eng.module.init_cache(B, 256, device=dev)
        logits, cache = eng.module.apply_with_cache(eng.net, ids, cache, 0)
        tok = logits[:, -1].argmax(-1).to(torch.int32)

        def step(t, tok):
            if fused:
                return eng._fused_step(layers, head, cache, tok, P + t - pads, P + t, starts).argmax(-1)
            logits, _ = eng.module.apply_with_cache(eng.net, tok[:, None].long(), cache, P + t, None,
                                                    pos + t)
            return logits[:, 0].argmax(-1)

        for t in range(2):  # warm
            step(t, tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                tok = step(t, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows, device_ms = device_profile(prof, steps)
    if not rows:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return
    log(f"profile of {steps} {what} decode steps (B={B}): per step wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {device_ms:.3f} ms = {device_ms / wall_ms:.4f} of wall "
        f"({device_ms / step_ms:.4f} of the {step_ms:.3f} ms step timed without the profiler)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  device {ms:8.4f} ms/step {n:5d} calls/step  {key[:80]}")


def llama_phase(torch):
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    B, P, NEW, L = 4, 128, 32, 2
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(
        get_model("llama3-8b", num_layers=L),
        config={"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512})
    log(f"llama3-8b (full width, depth cut to {L} of 32 layers to keep set-up short) int8 engine "
        f"built in {time.perf_counter() - t0:.1f} s")
    check(bool(eng._fused_decode_eligible()), f"llama3-8b: fused gate {eng._fused_decode_eligible()!r}")
    vocab = eng.model_config.vocab_size
    prompts = np.random.default_rng(SEED + 1).integers(0, vocab, (B, P)).astype(np.int32)
    reset_counts()
    out = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(eng.model_config, NEW, fused=True)
    log(f"llama3-8b greedy generate launches {counts}, expected {want}")
    check(counts == want, f"llama3-8b launch counts {counts} != {want}")
    check_tokens(out, B, NEW, vocab, "llama3-8b greedy")
    prefill_logits_check(torch, eng, prompts, "llama3-8b")
    fused_step_check(torch, eng, prompts, "llama3-8b")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 6-8: training


# bench.py:110-119, the JAX package's gpt2-large training config
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 4,
                "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.01}},
                "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 10**9,
                "telemetry": {}}


def flops_per_token(cfg, seq):
    """bench.py::_mfu's PaLM-style count: 6 N_nonemb + 12 L H T."""
    n_emb = cfg.vocab_size * cfg.hidden_size + (cfg.max_seq_len * cfg.hidden_size
                                                if cfg.pos_embedding == "learned" else 0)
    return 6 * (cfg.num_params() - n_emb) + 12 * cfg.num_layers * cfg.hidden_size * seq


def timed_steps(torch, engine, batch, n):
    """``n`` train steps, each timed on the host clock up to a synchronize;
    returns (losses, step seconds)."""
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(loss))
    return losses, secs


def train_profile(torch, engine, batch, step_ms, what, steps=2):
    """Device time by kernel over ``steps`` train steps (torch.profiler) and
    the device's busy share of the wall time, under the profiler and
    against ``step_ms``, the step timed without it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows, device_ms = device_profile(prof, steps)
    if not rows:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return
    log(f"profile of {steps} {what} train steps: per step wall {wall_ms:.3f} ms under the profiler, "
        f"device busy {device_ms:.3f} ms = {device_ms / wall_ms:.4f} of wall ({device_ms / step_ms:.4f} "
        f"of the {step_ms:.3f} ms step timed without the profiler)")
    kernel_ms = sum(r[1] for r in rows)
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  device {ms:9.4f} ms/step = {ms / kernel_ms:.4f} of device time {n:5d} calls/step  "
            f"{key[:70]}")


def train_phase(torch, card):
    """gpt2-large at full width and depth through initialize -> train_batch
    with bench.py's config. Returns the launch counts of the timed steps."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    WARM, TIMED, T = 3, 10, 1024
    t0 = time.perf_counter()
    model = get_model("gpt2-large", attention_impl="flash", remat_policy=None, scan_layers=False)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=dict(TRAIN_CONFIG))
    cfg = model.cfg
    B = engine.train_batch_size()
    log(f"gpt2-large train engine built in {time.perf_counter() - t0:.1f} s ({cfg.num_layers} layers, "
        f"hidden {cfg.hidden_size}, {cfg.num_heads} heads, vocab {cfg.vocab_size}; random weights from "
        f"seed {engine.config.seed}; micro batch {B}, seq {T}, bf16, AdamW)")
    batch = {"input_ids": np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    warm, warm_s = timed_steps(torch, engine, batch, WARM)
    log(f"gpt2-large warm-up steps: losses {[round(x, 4) for x in warm]}, "
        f"{[round(x * 1e3, 1) for x in warm_s]} ms")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(torch, engine, batch, TIMED)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_counts(cfg, TIMED)
    log(f"gpt2-large train launches over {TIMED} steps {counts}, expected {want}")
    check(counts == want, f"gpt2-large train launch counts {counts} != {want}")
    all_losses = warm + losses
    check(all(np.isfinite(all_losses)), f"gpt2-large: non-finite loss in {all_losses}")
    check(all_losses[-1] < all_losses[0], f"gpt2-large: loss did not fall: {all_losses}")
    gnorm = engine._last_metrics["grad_norm"]
    check(np.isfinite(gnorm) and not engine._last_metrics["overflow"],
          f"gpt2-large: grad norm {gnorm} (overflow {engine._last_metrics['overflow']})")
    step_s = statistics.median(secs)
    tok_s = B * T / step_s
    fpt = flops_per_token(cfg, T)
    mfu = fpt * tok_s / BF16_FLOP_PER_S
    log(f"gpt2-large train: losses {[round(x, 4) for x in losses]}, last grad norm {gnorm:.4f} "
        f"(clip 1.0), lr {engine._last_metrics['lr']:.3e}")
    log(f"gpt2-large train step (median of {TIMED}): {step_s * 1e3:.3f} ms (min {min(secs) * 1e3:.3f}, "
        f"max {max(secs) * 1e3:.3f}) = {tok_s:.1f} tokens/s, MFU {mfu:.4f} ({fpt / 1e9:.3f} GFLOP/token "
        f"over {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; {fpt * B * T / BF16_FLOP_PER_S * 1e3:.3f} ms/step at "
        f"peak) on {card}")
    log(f"gpt2-large train peak device memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated over the timed steps)")
    train_profile(torch, engine, batch, step_s * 1e3, "gpt2-large")
    del engine
    torch.cuda.empty_cache()
    return counts


# kernel path against plain path on one micro-step (bf16 compute through
# every layer): the loss, the global gradient norm, and the gradient of each
# head's slice of every attention projection's weight (the q/k/v columns and
# the o rows of that head, in every layer) as the relative L2 norm of its
# difference. The limits are set from the readings of sound runs and of
# planted faults (PERF.md).
PARITY_LOSS_REL = 1e-4
PARITY_NORM_REL = 1e-3
PARITY_HEAD_REL = 8e-2
# faults planted in the first backward call (the last layer), each of which
# the check must catch: (what, change to that call's (dq, dk, dv))
PLANTED_FAULTS = (("dk of head 0 zeroed", lambda dq, dk, dv: dk[:, 0].zero_()),
                  ("dq of head 0's last 64 query rows (one tile) zeroed",
                   lambda dq, dk, dv: dq[:, 0, -64:].zero_()))


def _head_errs(torch, keys, grads, ref, hd):
    """{(leaf, head): ||g - g_ref|| / ||g_ref||} over each head's slice of
    the attention projections' weights. (Their biases are left out: the k
    bias's gradient is zero in exact arithmetic, softmax being blind to a
    shift of a row's scores, so on the card it is rounding noise.)"""
    errs = {}
    for key, g, r in zip(keys, grads, ref):
        if ".attn." not in key or not key.endswith(".kernel"):
            continue
        if ".o_proj." in key:  # (heads * hd, hidden): a head's rows
            g, r = g.T, r.T
        g, r = g.reshape(g.shape[0], -1, hd), r.reshape(r.shape[0], -1, hd)
        rel = torch.linalg.vector_norm(g - r, dim=(0, 2)) / torch.linalg.vector_norm(r, dim=(0, 2))
        errs.update({(key, h): x for h, x in enumerate(rel.tolist())})
    return errs


def _global_norm(torch, grads):
    return float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))


def kernel_plain_parity(torch, engine, batch, what, plant_faults=False):
    """One micro-step's loss, global gradient norm and per-head attention
    weight gradients through the kernels and through their plain versions
    on the card (same weights and batch), within the ``PARITY_*`` limits.
    With ``plant_faults``, the kernel step runs again with each of
    ``PLANTED_FAULTS``, which the check must catch."""
    import numpy as np
    keys, hd = list(engine.params), engine.module.cfg.head_size
    lp, g_plain = engine._micro_loss_and_grads(engine.params, batch, 1.0, impl="plain")
    lp, n_p = float(lp), _global_norm(torch, g_plain)
    lk, g_kern = engine._micro_loss_and_grads(engine.params, batch, 1.0, impl="kernel")
    lk, nk = float(lk), _global_norm(torch, g_kern)
    errs = _head_errs(torch, keys, g_kern, g_plain, hd)
    del g_kern
    worst = max(errs, key=errs.get)
    log(f"{what} one micro-step, kernels vs plain on the card: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {abs(lk - lp) / abs(lp):.3e}, limit {PARITY_LOSS_REL:g}), grad norm {nk:.6f} vs "
        f"{n_p:.6f} (rel {abs(nk - n_p) / n_p:.3e}, limit {PARITY_NORM_REL:g}); per-head attention "
        f"weight gradients rel L2: worst {errs[worst]:.3e} ({worst[0]} head {worst[1]}), median "
        f"{statistics.median(errs.values()):.3e} over {len(errs)} slices (limit {PARITY_HEAD_REL:g})")
    check(np.isfinite([lk, nk]).all(), f"{what} parity: non-finite kernel-path loss or grad norm")
    check(abs(lk - lp) <= PARITY_LOSS_REL * abs(lp), f"{what} parity: loss {lk} vs plain {lp}")
    check(abs(nk - n_p) <= PARITY_NORM_REL * n_p, f"{what} parity: grad norm {nk} vs plain {n_p}")
    check(errs[worst] <= PARITY_HEAD_REL,
          f"{what} parity: {worst[0]} head {worst[1]} gradient differs from plain by rel L2 "
          f"{errs[worst]:.3e}")
    for fault, plant in PLANTED_FAULTS if plant_faults else ():
        _planted_fault(torch, engine, batch, what, keys, hd, g_plain, n_p, fault, plant)


def _planted_fault(torch, engine, batch, what, keys, hd, g_plain, n_p, fault, plant):
    """The kernel micro-step with ``plant`` applied to the first backward
    call's gradients: the parity check must fail on it."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    real, calls = fa.flash_attention_bwd, []

    def faulty(*args, **kwargs):
        grads = real(*args, **kwargs)
        if not calls:
            plant(*grads)
        calls.append(1)
        return grads

    fa.flash_attention_bwd = faulty
    try:
        _, g_bad = engine._micro_loss_and_grads(engine.params, batch, 1.0, impl="kernel")
    finally:
        fa.flash_attention_bwd = real
    nb = _global_norm(torch, g_bad)
    errs = _head_errs(torch, keys, g_bad, g_plain, hd)
    del g_bad
    worst = max(errs, key=errs.get)
    caught = errs[worst] > PARITY_HEAD_REL
    log(f"{what} planted fault, {fault} in one layer: grad norm rel {abs(nb - n_p) / n_p:.3e}; worst "
        f"head slice rel L2 {errs[worst]:.3e} ({worst[0]} head {worst[1]}): "
        f"{'caught' if caught else 'MISSED'}")
    check(caught, f"{what}: the parity check missed a planted fault ({fault})")


def train_parity_phase(torch):
    """gpt2-large width, depth cut to 4 layers: the kernel path against the
    plain path on one micro-step, and the check's power on planted faults."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    L, T = 4, 1024
    model = get_model("gpt2-large", num_layers=L, attention_impl="flash")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=dict(TRAIN_CONFIG))
    B = engine.train_batch_size()
    ids = np.random.default_rng(SEED).integers(0, model.cfg.vocab_size, (B, T))
    batch = {"input_ids": torch.as_tensor(ids, device=engine.device).long()}
    kernel_plain_parity(torch, engine, batch, f"gpt2-large ({L} of 36 layers)", plant_faults=True)
    del engine
    torch.cuda.empty_cache()


def llama_train_phase(torch):
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    L, T, STEPS = 2, 2048, 3
    t0 = time.perf_counter()
    model = get_model("llama3-8b", num_layers=L, attention_impl="flash")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1})
    log(f"llama3-8b train engine (full width, depth cut to {L} of 32 layers to fit set-up time and "
        f"memory) built in {time.perf_counter() - t0:.1f} s")
    batch = {"input_ids": np.random.default_rng(SEED + 1).integers(0, model.cfg.vocab_size, (1, T))}
    kernel_plain_parity(torch, engine, {"input_ids": torch.as_tensor(batch["input_ids"], device=engine.device)},
                        f"llama3-8b ({L} of 32 layers)")
    reset_counts()
    losses, secs = timed_steps(torch, engine, batch, STEPS)
    counts = read_counts()
    want = expected_train_counts(model.cfg, STEPS)
    log(f"llama3-8b train: losses {[round(x, 4) for x in losses]}, steps "
        f"{[round(x * 1e3, 1) for x in secs]} ms, launches {counts}, expected {want}")
    check(all(np.isfinite(losses)), f"llama3-8b: non-finite loss in {losses}")
    check(counts == want, f"llama3-8b train launch counts {counts} != {want}")
    del engine
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout: deepspeed_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"card: {card}")

    from deepspeed_tpu_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build_all([k[1].split("/")[-1][:-3] for k in KERNELS])
    log(f"built {len(logs)} kernel sources in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    results = kernel_phase(torch, dev)
    counts, fused_greedy = gpt2_large_phase(torch, card, fused=True)  # the main path
    for name, n in counts.items():
        results[name]["launches"] = n
    _, unfused_greedy = gpt2_large_phase(torch, card, fused=False)
    # the two paths round in other places (bias and RoPE in fp32 before the
    # cast in the fused kernels), so their streams may part where two logits
    # are close: reported, not required
    prefix = [next((i for i, (a, b) in enumerate(zip(f, u)) if a != b), len(f))
              for f, u in zip(fused_greedy, unfused_greedy)]
    log(f"gpt2-large greedy streams, fused vs per-projection: common prefix per row {prefix} "
        f"of {len(fused_greedy[0])}")
    llama_phase(torch)
    # the training path is the main path of the backward kernels
    train_counts = train_phase(torch, card)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        results[name]["launches"] = train_counts[name]
    train_parity_phase(torch)
    llama_train_phase(torch)
    for name, r in results.items():
        check(r["launches"] and r["launches"] > 0, f"{name} was never launched on the main path")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)  # as nvidia-smi gives it: name, power limit
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
