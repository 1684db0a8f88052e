#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. environment: torch/CUDA versions and the card's name and power limit;
2. kernels: builds the three CUDA kernels from ``deepspeed_tpu_torch/ops/csrc``
   (one nvcc per source, started together), compares each with its plain
   PyTorch version on the card at the main path's shapes, and times the
   kernel, the plain version and one PyTorch library call for the same
   function, beside the datasheet bound (3.35 TB/s, 989 TFLOP/s bf16);
3. the main path: gpt2-large (36 layers, full width, random weights from a
   seed) served through ``init_inference`` with int8 weights, kernel
   injection and ``fused_decode_block: False``; 8 prompts of 128 tokens,
   128 new tokens, greedy (twice: the streams must be identical) and
   sampled. Every kernel's launch count over the greedy run must equal the
   path's: quant_matmul (4*36+1)*128, flash 36, decode 36*127. The prefill
   logits of the kernel path are compared with the plain versions on the
   card, and the steady decode rate is measured;
4. llama3-8b at full width, depth cut to 2 layers (set-up time), so RoPE,
   RMSNorm, SwiGLU, GQA g=4 and the head-dim-128 kernels run end to end.

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


def flash_cases(torch, gen, dev):
    """gpt2-large prefill (B=8, H=20, T=128, D=64) and a llama3-8b shape
    (H=32, Hkv=8, T=512, D=128)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain, \
        flash_attention_with_lse
    for B, H, Hkv, T, D in ((8, 20, 20, 128, 64), (4, 32, 8, 512, 128)):
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


KERNELS = [
    # name, source, TPU kernel it replaces, case generator
    ("quant_matmul", "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
     "deepspeed_tpu/ops/pallas/quant_matmul.py:143", qmm_cases),
    ("flash_attention", "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:236", flash_cases),
    ("decode_attention", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198", decode_cases),
]


def kernel_phase(torch, dev):
    """Compare and time every kernel; returns {name: aggregate entry}."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    results = {}
    for name, source, replaces, cases in KERNELS:
        agg = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": None, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0, "cases": []}
        for label, kern, plain, library, nbytes, flops in cases(torch, gen, dev):
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
            case_err = 0.0
            # outputs in bf16 (the working type): one bf16 ulp at the largest
            # magnitude, 2^-7 of max|plain|; the flash lse (fp32 on both
            # sides, online vs direct softmax) within 1e-3
            for i, (o, r) in enumerate(pairs):
                err = float((o.float() - r.float()).abs().max())
                tol = 1e-3 if o.dtype == torch.float32 else 2.0**-7 * float(r.float().abs().max())
                check(err <= tol, f"{name} [{label}] output {i}: max abs err {err:.3e} > {tol:.3e}")
                check(bool(torch.isfinite(o.float()).all()), f"{name} [{label}] non-finite output")
                case_err = max(case_err, err)
            agg["max_abs_err"] = max(agg["max_abs_err"], case_err)
            k_ms, p_ms, l_ms = cuda_ms(kern, flush), cuda_ms(plain, flush, 3), cuda_ms(library, flush)
            b_ms, b_by = bound_ms(nbytes, flops)
            log(f"kernel {name} [{label}]: {k_ms:.4f} ms (plain {p_ms:.4f}, library {l_ms:.4f}, "
                f"bound {b_ms:.4f} by {b_by}), max abs err {case_err:.3e}")
            agg["ms"] += k_ms
            agg["plain_ms"] += p_ms
            agg["library_ms"] += l_ms
            agg["bound_ms"] += b_ms
            agg["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
            agg["ops_ms"] += flops / BF16_FLOP_PER_S * 1e3
            agg["cases"].append({"case": label, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                 "bound_ms": b_ms, "bound_by": b_by})
        agg["bound_by"] = "bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms") else "operations"
        results[name] = agg
    del flush
    return results


# ---------------------------------------------------------------------------
# phases 3-4: the main path


def counters():
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_with_lse
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    return {"quant_matmul": quant_matmul, "flash_attention": flash_attention_with_lse,
            "decode_attention": decode_attention}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def expected_counts(cfg, new_tokens):
    """Launches of one generate of ``new_tokens`` (no eos): every forward
    runs each layer's int8 projections (fused qkv, o, up, down, plus gate for
    a gated MLP) and the int8 head; prefill runs flash once per layer, each
    of the new_tokens - 1 decode steps the decode kernel once per layer."""
    L = cfg.num_layers
    projections = 5 if cfg.activation in ("swiglu", "geglu") else 4
    return {"quant_matmul": (projections * L + 1) * new_tokens, "flash_attention": L,
            "decode_attention": L * (new_tokens - 1)}


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


def gpt2_large_phase(torch, card):
    import numpy as np
    import deepspeed_tpu_torch
    B, P, NEW = 8, 128, 128
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(
        "gpt2-large", config={"dtype": "int8", "kernel_inject": True, "fused_decode_block": False,
                              "max_out_tokens": 512})
    log(f"gpt2-large int8 engine built in {time.perf_counter() - t0:.1f} s "
        f"(random weights, seed 0; host-side quantize)")
    vocab = eng.model_config.vocab_size
    prompts = np.random.default_rng(SEED).integers(0, vocab, (B, P)).astype(np.int32)
    eng.generate(prompts, max_new_tokens=8)  # first-use costs outside the counted run
    torch.cuda.synchronize()

    reset_counts()
    greedy = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(eng.model_config, NEW)
    log(f"gpt2-large greedy generate launches {counts}, expected {want}")
    check(counts == want, f"gpt2-large launch counts {counts} != {want}")
    check_tokens(greedy, B, NEW, vocab, "gpt2-large greedy")
    again = eng.generate(prompts, max_new_tokens=NEW)
    check(all(np.array_equal(a, b) for a, b in zip(greedy, again)),
          "gpt2-large greedy output differs between two runs")

    reset_counts()
    kw = dict(max_new_tokens=NEW, do_sample=True, temperature=0.8, top_k=50, top_p=0.95, seed=1)
    sampled = eng.generate(prompts, **kw)
    torch.cuda.synchronize()
    s_counts = read_counts()
    check(s_counts == want, f"gpt2-large sampled launch counts {s_counts} != {want}")
    check_tokens(sampled, B, NEW, vocab, "gpt2-large sampled")
    check(all(np.array_equal(a, b) for a, b in zip(sampled, eng.generate(prompts, **kw))),
          "gpt2-large sampled output differs between two runs with one seed")
    log(f"gpt2-large greedy row 0 starts {greedy[0][:8].tolist()}, sampled row 0 starts "
        f"{sampled[0][:8].tolist()}")

    prefill_logits_check(torch, eng, prompts, "gpt2-large")

    # steady decode rate as bench.py measures it: two run lengths split the
    # fixed cost (prefill, set-up) from the marginal decode step
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
    log(f"gpt2-large int8 decode, B={B}, prompt {P}: t(16)={times[16]:.4f} s, "
        f"t(144)={times[144]:.4f} s, steady step {step_s * 1e3:.3f} ms = {B / step_s:.1f} tok/s "
        f"on {card}")
    # a decode step reads every weight but the gathered embedding rows once,
    # and the live K/V window of every layer (mean position over the
    # differenced steps 16..144)
    mc = eng.model_config
    w_bytes = sum(t.numel() * t.element_size() for k, t in eng.params.items()
                  if not k.startswith(("embed.", "pos_embed")))
    kv_bytes = 2 * mc.num_layers * B * mc.kv_heads * mc.head_size * 2 * (P + 80)
    step_bound_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"gpt2-large decode step bound: ({w_bytes} weight + {kv_bytes} KV bytes) / 3.35 TB/s = "
        f"{step_bound_ms:.4f} ms; measured step is {step_s * 1e3 / step_bound_ms:.1f}x it")
    decode_profile(torch, eng, prompts, step_s * 1e3)
    del eng
    torch.cuda.empty_cache()
    return counts


def decode_profile(torch, eng, prompts, step_ms, steps=8):
    """Where a steady decode step's time goes: device time by kernel
    (torch.profiler, CUPTI) over ``steps`` decode steps after a prefill, and
    the device's busy share of the wall time, both under the profiler and
    against ``step_ms``, the step measured without it."""
    from torch.profiler import ProfilerActivity, profile
    B, P = prompts.shape
    ids = torch.as_tensor(prompts, device=eng.device).long()
    pos = torch.full((B, 1), P, dtype=torch.long, device=eng.device)
    with torch.inference_mode():
        cache = eng.module.init_cache(B, 256, device=eng.device)
        logits, cache = eng.module.apply_with_cache(eng.net, ids, cache, 0)
        tok = logits[:, -1].argmax(-1)[:, None]
        for t in range(2):  # warm
            eng.module.apply_with_cache(eng.net, tok, cache, P + t, None, pos + t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                logits, cache = eng.module.apply_with_cache(eng.net, tok, cache, P + t, None, pos + t)
                tok = logits[:, 0].argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return
    device_ms = sum(r[1] for r in rows)
    log(f"profile of {steps} gpt2-large decode steps (B={B}): per step wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {device_ms:.3f} ms = {device_ms / wall_ms:.4f} of wall "
        f"({device_ms / step_ms:.4f} of the {step_ms:.3f} ms step timed without the profiler)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  device {ms:8.4f} ms/step {n:5d} calls/step  {key[:80]}")


def llama_phase(torch):
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    B, P, NEW, L = 4, 128, 32, 2
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(
        get_model("llama3-8b", num_layers=L),
        config={"dtype": "int8", "kernel_inject": True, "fused_decode_block": False,
                "max_out_tokens": 512})
    log(f"llama3-8b (full width, depth cut to {L} of 32 layers to keep set-up short) int8 engine "
        f"built in {time.perf_counter() - t0:.1f} s")
    vocab = eng.model_config.vocab_size
    prompts = np.random.default_rng(SEED + 1).integers(0, vocab, (B, P)).astype(np.int32)
    reset_counts()
    out = eng.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_counts(eng.model_config, NEW)
    log(f"llama3-8b greedy generate launches {counts}, expected {want}")
    check(counts == want, f"llama3-8b launch counts {counts} != {want}")
    check_tokens(out, B, NEW, vocab, "llama3-8b greedy")
    prefill_logits_check(torch, eng, prompts, "llama3-8b")
    del eng
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
    log(f"built {len(logs)} kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    results = kernel_phase(torch, dev)
    counts = gpt2_large_phase(torch, card)
    for name, n in counts.items():
        results[name]["launches"] = n
    llama_phase(torch)
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
