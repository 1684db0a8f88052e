"""Sweeps of the block-sparse forward, dq and dk/dv kernels on the card.

``chunk``: the kernels at ``chip_smoke.py``'s block-sparse shapes
(gpt2-large's widths B 2, H 20, T 4096, D 64 at block 64, BigBird and Fixed
unidirectional; llama3-8b's B 1, H 32, D 128 at block 16, BigBird) with
work plans cut at several chunk lengths: the split rows and columns, the
dq and dk/dv workspaces, and the times (dq on the forward's plan, so its
split rows are the forward's). It is what ``CHUNK`` was chosen from.

``walk``: a wrap-around band layout in which every q block walks exactly w
kv blocks (and every kv block is read by w q blocks), at the same widths:
the time against w splits into a cost an item (its start: the first reads
come from device memory) and a cost a tile, with L2 flushed and warm.

Times are the median of 10 calls timed with CUDA events, the 50 MB L2
flushed before each (as ``chip_smoke.py`` times kernels), a sleep kernel
covering the host's enqueue. Run on the card, from the repo root:
``python -m deepspeed_tpu_torch.benchmarks.sparse_sweep [chunk] [walk]``.
"""

import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.sparse_attention import BigBirdSparsityConfig, FixedSparsityConfig
from ..ops.sparse_attention.block_sparse_attention import (WorkPlan, block_sparse_bwd_dkv, block_sparse_bwd_dq,
                                                           block_sparse_fwd, make_block_sparse_attention)

SEED = 0
SLEEP_CYCLES = 20_000_000  # ~10 ms at H100 clocks: covers the host time of a call


def shapes():
    """(label, B, H, T, D, config): chip_smoke.py's block-sparse kernel shapes."""
    fixed = FixedSparsityConfig(20, block=64, attention="unidirectional")
    return [("gpt2-large BigBird", 2, 20, 4096, 64, BigBirdSparsityConfig(20, block=64)),
            ("gpt2-large Fixed uni", 2, 20, 4096, 64, fixed),
            ("llama3-8b BigBird", 1, 32, 4096, 128, BigBirdSparsityConfig(32, block=16))]


def cuda_ms(fn, flush, iters=10):
    """Median device ms of one call of ``fn``; ``flush`` None keeps L2 warm."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _inputs(B, H, T, D, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    return [torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(4)]


def _calls(attn, plans, q, k, v, do, blk):
    """(forward, dq, dk/dv) closures over ``plans``; dq on the forward's
    plan, both backward kernels on the forward's out."""
    dev = q.device
    qi, qc, ki, kc = attn.tables(dev)
    out, lse = block_sparse_fwd(q, k, v, qi, qc, blk, attn.causal, plan=plans[0])
    delta = (do.float() * out.float()).sum(-1)
    return (lambda: block_sparse_fwd(q, k, v, qi, qc, blk, attn.causal, plan=plans[0]),
            lambda: block_sparse_bwd_dq(q, k, v, do, lse, delta, qi, qc, blk, attn.causal, plan=plans[0]),
            lambda: block_sparse_bwd_dkv(q, k, v, do, lse, delta, ki, kc, blk, attn.causal, plan=plans[1]))


def chunk_sweep(log=print):
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for label, B, H, T, D, cfg in shapes():
        blk = cfg.block
        causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
        attn = make_block_sparse_attention(cfg.make_layout(T), blk, causal)
        q, k, v, do = _inputs(B, H, T, D, dev)
        for c in ((8, 16, 24, 32, 64) if blk == 64 else (16, 32, 64, 128, 256)):
            plans = (WorkPlan(attn.np_tables[1], c), WorkPlan(attn.np_tables[3], c))
            fwd, dq, dkv = _calls(attn, plans, q, k, v, do, blk)
            dq_mib = plans[0].workspace_floats(B, blk, D) * 4 / 2**20
            mib = plans[1].workspace_floats(B, blk, 2 * D) * 4 / 2**20
            log(f"chunk {label} B={B} H={H} T={T} D={D} block {blk}, chunk {c}: fwd {cuda_ms(fwd, flush):.4f} ms "
                f"({len(plans[0].splits)} split rows), dq {cuda_ms(dq, flush):.4f} ms (workspace "
                f"{dq_mib:.1f} MiB), dkv {cuda_ms(dkv, flush):.4f} ms "
                f"({len(plans[1].splits)} split columns, workspace {mib:.1f} MiB)")


def walk_sweep(log=print):
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for (B, H, T, D, blk), walks in (((2, 20, 4096, 64, 64), (1, 2, 4, 8, 16)),
                                     ((1, 32, 4096, 128, 16), (1, 2, 4, 8, 16, 32))):
        q, k, v, do = _inputs(B, H, T, D, dev)
        nb = T // blk
        for w in walks:
            layout = np.zeros((H, nb, nb), np.int64)
            for t in range(w):
                layout[:, np.arange(nb), (np.arange(nb) - t) % nb] = 1
            attn = make_block_sparse_attention(layout, blk, causal=False)
            fwd, dq, dkv = _calls(attn, attn.plans, q, k, v, do, blk)
            log(f"walk B={B} H={H} T={T} D={D} block {blk}, walk {w} ({B * H * nb * w} tiles): "
                f"fwd {cuda_ms(fwd, flush):.4f} ms (warm {cuda_ms(fwd, None):.4f}), "
                f"dq {cuda_ms(dq, flush):.4f} ms (warm {cuda_ms(dq, None):.4f}), "
                f"dkv {cuda_ms(dkv, flush):.4f} ms (warm {cuda_ms(dkv, None):.4f})")


def main(argv):
    if not torch.cuda.is_available():
        print("sparse_sweep: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    which = argv or ["chunk", "walk"]
    log = lambda line: print(line, flush=True)
    if "chunk" in which:
        chunk_sweep(log)
    if "walk" in which:
        walk_sweep(log)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
