#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. environment: torch/CUDA versions and the card's name and power limit;
2. kernels: builds the CUDA kernels from ``deepspeed_tpu_torch/ops/csrc``
   (one nvcc per source, started together), compares each kernel (and
   the paged decode, paged span and int8-KV modes of the decode kernel)
   with its plain PyTorch version on the card at the main paths' shapes
   (the flash forward at the serving and the training shapes; the
   backward kernels on the plain forward's residuals; kernels A and C and
   the int8 head also at the scheduler's chunk width, M = 512),
   and times the kernel, the plain version and one PyTorch library call for
   the same function (for the two fused decode-layer kernels, which no
   single call computes, the chain of library calls instead; for the two
   flash backward kernels, scaled_dot_product_attention's forward and
   backward, beside the port's forward and backward), beside the datasheet
   bound (3.35 TB/s, 989 TFLOP/s bf16); the flash forward and the backward
   kernels must also give bitwise-equal outputs on two calls, and the flash
   forward's rows must hold a relative L2 gate that catches two planted
   faults of its K/V walk (``flash_planted_faults``: a skipped 128-key
   tile, a ring off by one stage), the backward's rows of dq, dk and dv
   one that catches three of its walks (``flash_bwd_planted_faults``: a
   K/V tile skipped by dq's long rows, a Q/dO tile skipped by dk/dv's
   first kv tiles, the dk/dv ring off by one stage); kernels A and C's
   rows must hold a relative L2 gate too; ``quant_matmul``'s rows, and
   kernels A and C's (``block_invariance``: M = 1 to 512 against M = 512
   at gpt2-large and llama3-8b, with a planted fault the gate must catch),
   must not depend on M (``quant_matmul``'s column blocks must not depend
   on N either: ``qmm_column_split``, llama3-8b's fused qkv against its
   split q, k, v and gate/up and the head against their halves, what the
   tensor-parallel serving layout rests on), the kernel rows include
   llama3-8b's shapes on one rank of tensor parallelism 2 (16/4 heads, q N
   2048, k/v N 512, gate/up N 7168, the head N 64512; flash, paged decode
   and span, bf16 and int8 KV), and the decode kernel's invariants must hold bitwise at
   gpt2-large's and llama3-8b's heads, bf16 and int8 KV
   (``decode_invariance``: span column == decode, chained == one big slot
   at chunk and extent boundaries, NaN outside the windows changing no bit);
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
   Then the serving path on the same engine (its config carries
   ``bench.py::_serving_bench``'s continuous-batching section: 8 slots,
   K=4, chunk 64): the mixed stream (32 requests, prompts 8-191 tokens, 64
   new each, all queued at t = 0) through ``engine.scheduler()``, with exact
   launch counts (kernels A and C 36 per forward, the paged decode kernel
   36 per width-1 forward, the span kernel 36 per chunk forward, the int8
   head once per forward), tokens/s, TTFT p50/p95 and sync times; one chunk
   and one decode step of kernels against plain; the stream again at K=4
   and at K=1 (identical streams); the shared-prefix stream (radix hits, a
   hit's logits bitwise equal to the same prompt cold, a retained slot
   byte-stable while dead); profiles of chunk and decode syncs; the same
   mixed stream's first ``YARDSTICK_REQUESTS`` through sequential
   ``generate()`` calls (bench.py's yardstick, a rate); the int8 KV leg (the first 8 requests on an int8 pool
   against the bf16 pool: the JAX bound, >= 1.9x rows per byte, the int8
   kernel variants' launches); the speculative leg (bench.py's
   7-token-pattern stream at spec_tokens 4 against 0 on fresh schedulers,
   bf16 and int8 KV: greedy streams and a sampled one bitwise equal, exact
   launch counts, drafts accepted and more than one token per (row,
   verify), tokens/s of both, a verify sync's device busy share); and the
   monolithic leg (``prefill_chunk=0``, the mixed stream: exact counts per
   prefill bucket, each bucket's first-token logits kernels vs plain,
   tokens/s, TTFT, streams parting from the chunked run's);
   Then the gateway phase on the fused engine's weights (``params=``):
   ``quantize_kv_rows`` on the card bitwise its CPU run at fp16 scale
   edges; the same serving config behind the HTTP gateway with telemetry on
   (``deepspeed_tpu_torch.serving.Gateway``, port 0): the mixed stream as 32
   concurrent streaming POSTs, each SSE stream bitwise its direct
   ``scheduler().submit()``, exact launch counts, HTTP tokens/s beside the
   in-process stream's, TTFB and queue wait, the capacity gauges
   (``serving/mfu``, ``serving/hbm_bw_util`` in (0, 1.05]) and the host-gap
   buckets in ms per sync (summing to ``serving/host_gap_ms`` within 1%),
   ``/v1/metrics`` as JSON and Prometheus text, a drain and a 503 after it;
   the int8-KV leg (8 requests, bitwise, exact counts) under a ``POST
   /v1/debug/profile`` capture (409 on a second; the device busy share);
   ``tools/trace_summary.py`` on the JSONL;
   Then the serving fleet (``fleet_phase``; ``python3 chip_smoke.py
   --fleet`` runs it alone) on the same weights: (a) the mixed stream's 32
   concurrent streaming POSTs through a gateway of one replica and of two
   (``continuous_batching.replicas``), every SSE stream bitwise its direct
   one-replica submit, launch counts exact as the sum over the replicas,
   both replicas placed, HTTP tokens/s at 1 and 2, each replica's sync
   launch and wait in ms; (b) the shared-prefix stream at 2, bitwise, with
   sticky dispatches and radix hits, under a ``/v1/debug/profile`` capture
   (the fleet's device busy share; a missing capture fails); (d) on the
   same gateway, replica 1's step failing from its third call: its
   requests fail, replica 0 finishes the rest bitwise, the fleet drains;
   (c) ``["prefill", "decode"]`` roles in process over one host store, the
   whole mixed stream at t = 0, bf16 and int8 KV, greedy and sampled:
   tokens and logits bitwise the one-replica run, every request migrated
   (out == in), each handoff's D2H and H2D by CUDA events and its bytes,
   wall, TTFT and ITL beside the one-replica run; (e) llama3-8b (2 layers) int8 at tp
   2, two processes over gloo, rank 0 serving HTTP and rank 1 following:
   8 concurrent streams bitwise tp 1's direct submits, exact launches on
   each rank, a client disconnecting mid-decode freeing the slot on both
   ranks, both ranks exiting 0;
   Then the hierarchical KV tier (``kv_tier_phase``; ``python3
   chip_smoke.py --kv-tier`` runs it alone) on the same weights, the
   serving configuration with ``hierarchical_kv`` at 4096 MB of host RAM:
   (a) 16 prompts of a 384-token system prefix and a 32-token suffix, 64
   new each, served cold (the 8-slot pool demotes them), then every prefix
   again with a new suffix, each restored from the host tier: exact launch
   counts (36 x 6 span launches fewer a restored prefix), TTFT of both
   passes, the demote's D2H and the restore's H2D by CUDA events, the host
   gap's ``tier_transfer`` share; 4 revisits (greedy and sampled) restored
   == device hit == cold with the tier off, bitwise in tokens and logits,
   on the bf16 pool and again on an int8 pool; (b) the same two passes
   over 256 MB of host RAM spilling to NVMe under a temporary directory,
   bitwise (a)'s, with spills, NVMe bytes, the ``O_DIRECT`` share and the
   TTFT of revisits restored from disk; (c) in phase 5, on the llama3-8b
   engine, a request chained to 7968 tokens whose cold extents are demoted
   mid-decode and restored by the paging pump: stream and logits bitwise
   the run without demotion, exact extent-mode launches, each extent's
   demote and restore time;
5. llama3-8b at full width, depth cut to 2 layers (set-up time), fused, so
   RoPE, RMSNorm, SwiGLU, GQA g=4 and the head-dim-128 kernels run end to
   end, through generate() and through the scheduler (4 slots, 8 requests);
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
   finite losses and exact launch counts;
8a. mixtral-8x7b (``moe_phase``; ``python3 chip_smoke.py --moe`` runs it
   alone), full width (8 experts of 4096 x 14336, top 2), depth cut to 2
   of 32 layers (host set-up, device memory), seeded random weights made
   on the card: (a) ``comm`` on an NCCL group of world 1 and
   ``initialize_mesh(expert=1)``, every collective returning its input on
   cuda, the group destroyed; (b) int8 serving through the per-projection
   path (the fused gate refuses MoE, the JAX engine's reason): greedy
   ``generate()`` B 4, prompt 128, 32 new, twice bitwise, then sampled
   twice bitwise, exact launch counts, prefill, decode-step and slot-pool
   step logits kernels vs plain within 5e-2 relative L2 on a view routing
   every token to all 8 experts (a top-2 routing flip changes a token
   wholly; the top-2 comparison is logged), routed counts
   summing to top-2 x the live columns, the steady decode step and its
   device time split (experts, attention, the rest), a 4-slot stream of 8
   requests (16-200 tokens, 32 new) with exact launch counts, tokens/s and
   TTFT, each stream bitwise its solo run and beside generate()'s row,
   peak memory and set-up time; (c) bf16 training, ``initialize`` ->
   ``train_batch`` (AdamW, fp32 masters, clip 1.0, micro 1, seq 2048): the
   first micro-step's loss and grad norm kernels vs plain within
   ``MOE_LOSS_REL`` / ``MOE_NORM_REL``, 3 steps with finite losses and grad
   norms, exact flash launches, step ms, peak memory, the aux loss and the
   drop fractions;
8b. the training engine's features (``train_features_phase``; ``python3
   chip_smoke.py --train-features`` runs it alone): gpt2-large at full
   width, 18 of 36 layers (``FEATURE_LAYERS``), bench.py's config, through ``initialize`` ->
   ``train_batch`` under no remat, ``nothing_saveable``, ``dots_saveable``
   and ``dots_and_attn_saveable``: the first step's loss and grad norm
   against no remat (bitwise, or within ``PARITY_LOSS_REL`` /
   ``PARITY_NORM_REL``, the log says which), exact launch counts (flash
   forward twice a layer and step under the first two policies, once
   otherwise; dq and dk/dv once), the peak device memory (``nothing_saveable``
   must be below no remat) and the median of 3 steps after 1, with a
   profile of one step; dropout 0.1 under ``nothing_saveable``: two engines
   from one seed bitwise over 3 steps, the first step's grad norm with
   remat off against on, the counter-hash mask on the card bitwise the
   CPU's at (4, 1024, 1280); Adam (``adam_w_mode`` false), Adagrad, LAMB,
   SGD, Lion and a client ``torch.optim.AdamW``: 2 steps at 4 layers (fp32,
   the plain attention) on the card against the CPU within
   ``OPT_LOSS_REL`` / ``OPT_UPDATE_REL``; checkpoints: 2 steps, a sync and
   an async save, each loaded into a fresh engine whose next 2 steps are
   bitwise the uninterrupted run's (losses and master), the seconds and
   bytes, and the 16-bit export loaded back bitwise the bf16 cast of the
   master;
8c. the offload tiers (``offload_phase``; ``python3 chip_smoke.py
   --offload`` runs it alone; the host C code, ``cpu_adam.c`` and ``aio.c``,
   builds with ``cc`` at first use): (a) ZeRO-Offload, gpt2-large at full
   depth with bench.py's config and ``offload_optimizer: cpu``: the first
   step's loss bitwise the on-device engine's on the same weights, the
   masters after it within ``OFFLOAD_MASTER_REL`` of the update from the
   on-device AdamW, the loss falling over 3 + 5 steps with exact flash
   launches, the peak device memory, the host GiB and the step split
   (device forward and backward, fetch, host AdamW, push); (b) its NVMe
   tier (``offload_optimizer: nvme`` under a temporary directory, or
   ``$CHIP_SMOKE_NVME_DIR``; at ``NVME_LAYERS`` of 36 layers, fewer where
   the disk cannot hold master and moments, the cut logged), 2 steps whose
   masters are bitwise the CPU tier's at that depth, with the bytes read and written through ``O_DIRECT`` and
   buffered; (c) ZeRO-Infinity, llama3-8b at full width with ``stage: 3,
   offload_param: cpu``, seq 2048: at 2 layers the streamed step's loss and
   grad norm against the on-device engine's on the same weights, then at
   the deepest depth whose host state (18 bytes a parameter) fits 0.6 of
   MemAvailable, 1 warm-up and 2 timed steps with exact flash launches (2 L
   forwards, L dq, L dk/dv a step: the backward recomputes each block),
   peak device memory, host GiB, the step split and overlap gauges,
   tokens/s and MFU; (d) ZeRO-Inference, ``param_stream.generate`` on (c)'s
   2-layer weights: greedy tokens equal the dense ``generate()``'s, with
   exact flash and decode launches;
8d. ZeRO stages 0-3 (``zero_phase``; ``python3 chip_smoke.py --zero`` runs
   it alone): llama3-8b at full width, depth cut to 2 layers, seq 2048,
   micro 1, gas 2, bf16 compute, fp32 master AdamW, clip 1.0, seeded
   weights made on the card, an NCCL world of 1 from ``init_distributed()``
   (every shard whole; stage 3 still gathers, releases and re-gathers each
   block, prefetches on a side stream and reduces each gradient through
   its gather): 3 steps at each stage on the same weights and batches,
   engines freed in turn; stages 1 and 2 bitwise stage 0 (losses and
   master), stage 3 within ``ZERO_LOSS_RTOL`` of its losses and
   ``ZERO_MASTER_REL_L2`` of each master tensor, and bitwise a second
   stage-3 run; exact flash launches at every stage and exact block gathers
   at stage 3 (L + 2 a micro-step forward, L + 1 backward); step ms, peak
   GiB and the ``comm/overlap_efficiency`` and ``comm/all_gather`` gauges
   per stage; a checkpoint saved at stage 3 before its last step resumes
   at stage 3 (that step bitwise) and at stage 0 (the master bitwise);
8e. tensor parallelism (``tp_phase``; ``python3 chip_smoke.py --tp`` runs
   it alone): llama3-8b at full width, 2 of 32 layers, seeded weights made
   on the card; tp 1 in this process, then tp 2 as two spawned processes
   sharing the card over a gloo group whose collectives take the CUDA
   tensors (``tp_gloo_check``; NCCL refuses two ranks on one card; the
   ranks load the kernels built here): (a) int8 serving, kernel-injected,
   per projection at both degrees (the fused decode layer is off at tp >
   1): ``generate()`` B 4, prompt 128, 32 new, greedy and sampled, the
   prefill logits, a 4-slot stream of 8 requests and an int8-KV stream of
   4, tokens and logits bitwise tp 1's on both ranks, exact launch counts a
   rank (kernels A and C at 0), the ready line's tensor part; (c) bf16
   training, seq 2048, micro 1, AdamW, stages 0 and 3 at tp 2 against
   stage 0 at tp 1: losses and grad norms within ``TP_LOSS_REL`` /
   ``TP_NORM_REL``, bitwise across the ranks, exact flash launches, peak
   GiB a rank; two faults planted in the copy-to-region backward (its
   reduction doubled, its reduction left out), one stage-0 step each, must
   leave the grad-norm gate at the first step; step and sync times of two processes sharing one card are
   logged and are no tensor-parallel speed;
8f. pipeline parallelism (``pipe_phase``; ``python3 chip_smoke.py --pipe``
   runs it alone): gpt2-large at full width, 18 of 36 layers (9 a stage),
   seeded weights made on the card, bench.py's config at gas 4 (M = 4 over
   S = 2); pp 1 in this process, then pp 2 as two spawned processes
   sharing the card over a gloo group (``pipe_gloo_check``: one exchange
   each way and a partial ``ppermute`` on CUDA tensors, bf16 and fp32,
   staged through host memory); under fill-drain and 1F1B, 2 steps each on
   the same weights and batches: losses and grad norms within
   ``PIPE_LOSS_REL`` / ``PIPE_NORM_REL`` of pp 1's, 1F1B bitwise
   fill-drain, the replicated tensors bitwise across the ranks after each
   step, exact flash forward, dQ and dK/dV launches a rank a step; a
   checkpoint saved at pp 2 resumes at pp 2 (that step and the master
   bitwise) and loads at pp 1 here (the master bitwise); two planted faults
   (the replicated tensors' gradient sum over pipe left out, one
   microbatch's activation gradient dropped) must leave the grad-norm gate
   at the first step; peak GiB a rank and step times (no pipeline speed)
   logged;
8g. sequence parallelism (``seq_phase``; ``python3 chip_smoke.py --seq``
   runs it alone): llama3-8b at full width, 2 layers, bf16, AdamW, micro 1,
   seq 8192, seeded weights made on the card; sp 1 in this process, then
   sp 2 as two spawned processes sharing the card over a gloo group
   (``seq_gloo_check``: the all-to-all over ``seq``, point to point and
   staged through host memory, and a ring ``ppermute`` on CUDA tensors),
   under Ulysses and ring zig-zag: the first micro-step's attention weight
   gradients within ``SEQ_GRAD_REL`` relative L2 of sp 1's, 2 steps on
   two batches with losses and grad norms within ``SEQ_LOSS_REL`` /
   ``SEQ_NORM_REL`` of sp 1's and equal on the two ranks, exact flash
   forward, dq and dk/dv launches a rank (the ring's two steps a layer each
   run again by its checkpoint), peak GiB a rank; three planted faults
   must leave their gates: the ring's causal keep dropped and the Ulysses
   all-to-all's member order reversed the gradient gate, the seq gradient
   sum left out of the engine's reduction (one ``train_batch`` step on a
   fresh engine) the first step's grad norm gate; the int8 stream at the
   serving defaults (the fused decode block on) with seq-parallel prefill
   (128-column wide chunks split over the ranks, per projection at sp 1
   and sp 2) bitwise sp 1's, tokens and logits, launches equal; the kernel
   phase holds the flash kernels at the seq phase's causal shapes (sp 1, a
   Ulysses rank, the zig-zag diagonal) and at the ring's non-causal
   rectangular steps (forward, and the backward with an lse cotangent),
   and the span kernel at a seq rank's 64 columns;
9. block-sparse attention, the main path of its three kernels: at
   gpt2-large's attention widths (B 2, H 20, T 4096, D 64), block 64, bf16,
   ``SparseSelfAttention`` forward and ``.backward()`` for each non-dense
   ``SparsityConfig`` at its defaults (Fixed unidirectional) and BigBird
   unidirectional: exactly one forward, one dq and one dk/dv launch a call,
   two calls bitwise equal, one cached layout per sequence length, out and
   gradients within 2^-7 of max|plain| and 2e-3 relative L2 error, dq's
   rows also within 2^-6 (``impl="plain"``, on the same work plans); the
   three kernels on their default plans (walks longer than the block
   size's chunk split over CTAs and merged in piece order; dq on the
   forward's) against one-piece plans; three planted faults failing those
   relative-L2 gates (one kv block dropped from one q block's walk; one q
   block dropped from the second piece of a split global column, which the
   dk/dv merge sums; one kv block dropped from the second piece of a split
   global row, which the dq merge sums); the all-ones
   causal layout against the dense flash kernels; the sparse
   forward+backward times beside dense flash's. The kernel phase holds the
   three kernels against their plain versions at gpt2-large's widths
   (BigBird; Fixed unidirectional, also at a ragged T 4056) and llama3-8b's
   (H 32, D 128, block 16, BigBird), timed beside
   scaled_dot_product_attention with the layout expanded to a boolean mask;
10. the decode-shape microbench (``deepspeed_tpu_torch.benchmarks.
   qmm_microbench``), the main path of the qmm2, qmm3 and qmm4 kernels: its
   eight variants at L 36 with ms a pass, GB/s, relerr against bf16, the
   byte bound and the per-launch time, and exact launch counts. The kernel
   phase holds the three kernels against their plain versions at
   8x1280x5120 (qmm4 bitwise, qmm2 at block_n 512, 1024 and 2560; two calls
   bitwise equal) beside the dequantize-then-matmul chain, and two faults
   planted in the kernel must fail those gates (``micro_planted_faults``: a
   group dropped from one strip's walk, groups summed in reverse order).
Each phase prints its wall seconds.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
``deepspeed_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""

import json
import math
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


# the scheduler's chunk step at gpt2-large width: 8 slots x 64 columns
CHUNK_M = 512


# (name, K, N): gpt2-large's projections and padded int8 head, then
# llama3-8b's (fused qkv, o, fused gate/up, down, padded head)
QMM_GPT2 = [("qkv", 1280, 3840), ("o", 1280, 1280), ("up", 1280, 5120), ("down", 5120, 1280),
            ("head", 1280, 51200)]
QMM_LLAMA = [("llama qkv", 4096, 6144), ("llama o", 4096, 4096), ("llama up", 4096, 14336),
             ("llama down", 14336, 4096), ("llama head", 4096, 129024)]
# mixtral-8x7b's int8 head, vocab 32000 padded to 32768: at its decode
# (M = B = 4) and its scheduler's chunk step (4 slots x 64 columns)
QMM_MIXTRAL_HEAD = ("mixtral head", 4096, 32768)
# llama3-8b's projections on one rank of tensor parallelism 2 (the split q,
# k and v: 16 and 4 of the 32 and 8 heads; gate/up 7168 of 14336 columns;
# the head 64128 of the 128256-vocab head padded to 129024 / 2 = 64512):
# at tp_phase's generate() decode (M = B = 4) and prefill (M = 4 x 128).
# o and down stay whole (the bitwise all-gather layout): the rows above
QMM_LLAMA_TP2 = [("llama tp2 q", 4096, 2048), ("llama tp2 k/v", 4096, 512), ("llama tp2 gate/up", 4096, 7168),
                 ("llama tp2 head", 4096, 64512)]
TP_M = (4, 512)
# the rows whose bits must not depend on M: every tile edge of the kernel
QMM_INVARIANT_M = (1, 8, 16, 32, 33, 64, 65, 512, 1024)


def qmm_cases(torch, gen, dev):
    """gpt2-large's projections (int8, group 128) and int8 head, at decode
    (M = B = 8) and prefill (M = B*P = 1024), the int8 head at the
    scheduler's chunk step (M = 8 slots x 64 columns), llama3-8b's at
    M = 1024 (a long-context chunk of 16 slots x 64), a ragged M of
    1000 and M = 64 (a tile edge) at gpt2-large's up projection, and
    mixtral-8x7b's int8 head at its decode (M = 4) and chunk step (M =
    256)."""
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    cases = ([(M, *sh) for M in (8, 1024) for sh in QMM_GPT2] + [(CHUNK_M, "head", 1280, 51200)]
             + [(1024, *sh) for sh in QMM_LLAMA] + [(1000, "up", 1280, 5120), (64, "up", 1280, 5120)]
             + [(M, *QMM_MIXTRAL_HEAD) for M in (MOE_B, MOE_SLOTS * 64)]
             + [(M, *sh) for M in TP_M for sh in QMM_LLAMA_TP2])
    for M, proj, K, N in cases:
        G = K // 128
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        qw = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((G, N), generator=gen, device=dev) * 0.01 + 1e-4
        w_deq = (qw.float().reshape(G, K // G, N) * sc[:, None, :]).reshape(K, N).to(torch.bfloat16)
        nbytes = M * K * 2 + K * N + G * N * 4 + M * N * 2
        kind = {8: "decode", 1024: "prefill", CHUNK_M: "chunk step", MOE_B: "decode",
                MOE_SLOTS * 64: "chunk step"}.get(M, "ragged")
        if "tp2" in proj:
            kind = {4: "tp 2 rank decode", 512: "tp 2 rank prefill"}[M]
        yield (f"{kind} {proj} M={M} K={K} N={N}",
               lambda x=x, qw=qw, sc=sc: quant_matmul(x, qw, sc),
               lambda x=x, qw=qw, sc=sc: quant_matmul_plain(x, qw, sc),
               lambda x=x, w=w_deq: torch.matmul(x, w),
               nbytes, 2 * M * K * N)


def qmm_invariance(torch, dev):
    """Batch invariance on the card: at each of the ten shapes, rows of
    quant_matmul(x[:m]) are bitwise the same rows of quant_matmul(x) (M =
    1024) for every m of QMM_INVARIANT_M, and two calls on the same inputs
    are bitwise equal. Launches here are not the main path's."""
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for proj, K, N in QMM_GPT2 + QMM_LLAMA:
        x = torch.randn((max(QMM_INVARIANT_M), K), generator=gen, device=dev).to(torch.bfloat16)
        qw = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((K // 128, N), generator=gen, device=dev) * 0.01 + 1e-4
        full = quant_matmul(x, qw, sc)
        check(torch.equal(quant_matmul(x, qw, sc), full), f"quant_matmul {proj}: two calls differ")
        for m in QMM_INVARIANT_M:
            part = quant_matmul(x[:m], qw, sc)
            diff = int((part != full[:m]).sum())
            check(diff == 0, f"quant_matmul {proj} {K}x{N}: rows of M={m} differ from M="
                  f"{x.shape[0]} in {diff} entries")
        check(bool(torch.isfinite(full).all()), f"quant_matmul {proj}: non-finite output")
    torch.cuda.synchronize()
    log(f"quant_matmul batch invariance: rows bitwise equal for M in {QMM_INVARIANT_M} and two "
        f"calls bitwise equal, at {len(QMM_GPT2 + QMM_LLAMA)} shapes")


# the whole projections and the column splits tensor parallelism 2 makes of
# them (bitwise all-gather layout): llama3-8b's fused qkv against its split q,
# k, v on one rank; gate/up and the padded head against their halves
QMM_SPLITS = [("llama qkv", 4096, (2048, 512, 512, 2048, 512, 512)), ("llama gate/up", 4096, (7168, 7168)),
              ("llama head", 4096, (64512, 64512))]


def qmm_column_split(torch, dev):
    """Column stability on the card (what tp 2 == tp 1 bitwise rests on):
    for each of ``QMM_SPLITS``, quant_matmul over column blocks of the
    whole weight, concatenated, is bitwise quant_matmul over the whole, at
    every M of ``TP_M`` and 1, 33 (the split plan's M <= 32 edge): the
    kernel's split plan follows N, its bits must not."""
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for proj, K, cols in QMM_SPLITS:
        N = sum(cols)
        qw = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((K // 128, N), generator=gen, device=dev) * 0.01 + 1e-4
        edges = [0]
        for c in cols:
            edges.append(edges[-1] + c)
        for M in (1, 33) + TP_M:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            whole = quant_matmul(x, qw, sc)
            parts = torch.cat([quant_matmul(x, qw[:, a:b].contiguous(), sc[:, a:b].contiguous())
                               for a, b in zip(edges, edges[1:])], dim=1)
            diff = int((parts != whole).sum())
            check(diff == 0, f"quant_matmul {proj} {K}x{N} at M={M}: the column blocks {list(cols)} "
                  f"differ from the whole in {diff} entries")
    torch.cuda.synchronize()
    log(f"quant_matmul column splits: blocks bitwise the whole at M in {(1, 33) + TP_M}, at "
        f"{len(QMM_SPLITS)} splits")


def _block_layer(torch, gen, dev, H, nh, nkv, hd, F_, act, norm, rope, M):
    """Kernel A's and kernel C's operands at one layer shape, M rows; returns
    (A(m), C(m)) calls on the first m rows."""
    from deepspeed_tpu_torch.ops.decode_block import fused_out_mlp, fused_qkv_ln
    N = (nh + 2 * nkv) * hd
    x = (torch.randn((M, H), generator=gen, device=dev) * 2).to(torch.bfloat16)
    attn = torch.randn((M, nh * hd), generator=gen, device=dev).to(torch.bfloat16)
    norms = _norm_rows(torch, gen, dev, H, norm)
    qkv, o, up, down = (_proj(torch, gen, dev, H, N), _proj(torch, gen, dev, nh * hd, H),
                        _proj(torch, gen, dev, H, F_), _proj(torch, gen, dev, F_, H))
    gate = _proj(torch, gen, dev, H, F_) if act in ("swiglu", "geglu") else None
    ang = torch.rand((M, hd // 2), generator=gen, device=dev) * 6.0
    sin, cos = torch.sin(ang), torch.cos(ang)

    def a(m):
        r = (sin[:m].contiguous(), cos[:m].contiguous(), nh + nkv, hd) if rope else None
        return fused_qkv_ln(x[:m], norms, qkv, norm=norm, rope=r)

    def c(m):
        return fused_out_mlp(attn[:m], x[:m], norms, o, up, down, activation=act, norm=norm, gate=gate)

    return a, c


def _rows_differing(torch, fn, full):
    """{m: entries of fn(m) that differ from the first m rows of full}, for
    each m of BLOCK_INVARIANT_M."""
    out = {m: int((fn(m) != full[:m]).sum()) for m in BLOCK_INVARIANT_M}
    torch.cuda.synchronize()
    return out


def block_invariance(torch, dev):
    """Batch invariance of kernels A and C on the card: at gpt2-large's and
    llama3-8b's layer shapes (RoPE at hd 128 and swiglu at llama3-8b), the
    rows of every M of BLOCK_INVARIANT_M are bitwise the same rows at M =
    512, and two calls on the same inputs are bitwise equal; the scheduler's
    decode, verify and chunk steps rest on it. Then a planted fault (the
    wgmma path with the chain in registers sums K's segments in reverse order:
    ``decode_block._plant``) must break it. Launches here are not the main
    path's."""
    from deepspeed_tpu_torch.ops import decode_block
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    checks = 0
    for label, _, H, nh, nkv, hd, F_, act, norm, rope in LAYER_SHAPES[:2]:
        a, c = _block_layer(torch, gen, dev, H, nh, nkv, hd, F_, act, norm, rope, max(BLOCK_INVARIANT_M))
        for kern, fn in (("fused_qkv_ln", a), ("fused_out_mlp", c)):
            full = fn(max(BLOCK_INVARIANT_M))
            check(torch.equal(fn(max(BLOCK_INVARIANT_M)), full), f"{kern} {label}: two calls differ")
            check(bool(torch.isfinite(full.float()).all()), f"{kern} {label}: non-finite output")
            diff = _rows_differing(torch, fn, full)
            bad = {m: d for m, d in diff.items() if d}
            check(not bad, f"{kern} {label}: rows differ from M={max(BLOCK_INVARIANT_M)} at {bad}")
            checks += len(diff) + 1
            decode_block._plant = 1
            try:
                planted = _rows_differing(torch, fn, fn(max(BLOCK_INVARIANT_M)))
            finally:
                decode_block._plant = 0
            caught = sum(1 for d in planted.values() if d)
            log(f"  block invariance {kern} {label}: {len(diff)} widths bitwise; the planted fault "
                f"(K's segments chained in reverse on the wgmma path) makes {caught} widths differ")
            check(caught > 0, f"{kern} {label}: the invariance gate missed the planted fault")
    log(f"kernels A and C batch invariance: {checks} bitwise checks (rows of M in {BLOCK_INVARIANT_M} "
        f"== M={max(BLOCK_INVARIANT_M)}, two calls equal) at gpt2-large and llama3-8b; planted fault caught")


# the decode-shape microbench's layer (benchmarks/qmm_microbench.py): x (8,
# 1280) bf16 against one 1280 x 5120 int8 layer, groups of 128
MICRO_M, MICRO_K, MICRO_N, MICRO_GS = 8, 1280, 5120, 128


def micro_cases(torch, gen, dev, which):
    """qmm2 at the bench's three column tiles (one grid: block_n sets
    nothing on the card), qmm3 and qmm4 at 2560, on the bench's data (x ~
    0.1 N(0, 1), w ~ 0.02 N(0, 1) quantized per group), beside the library
    chain (dequantize to bf16, then one cuBLAS matmul with fp32 output).
    qmm4 quantizes x inside its kernel; its row also times the eager
    ``quantize_rows`` alone (``quantize_rows_ms``), the time that saves. The
    ops count of qmm4 is given in bf16-equivalent operations (half of its
    int8 operations: the int8 peak is twice the bf16 one)."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    M, K, N, gs = MICRO_M, MICRO_K, MICRO_N, MICRO_GS
    G = K // gs
    x = (torch.randn((M, K), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    sc = w.reshape(G, gs, N).abs().amax(1) / 127.0 + 1e-8
    qw = torch.clamp(torch.round(w.reshape(G, gs, N) / sc[:, None]), -127, 127).to(torch.int8).reshape(K, N)
    del w

    def library(x=x, qw=qw, sc=sc):
        wd = (qw.to(torch.bfloat16).reshape(G, gs, N) * sc[:, None, :].to(torch.bfloat16)).reshape(K, N)
        return torch.mm(x, wd, out_dtype=torch.float32)

    nbytes = M * K * 2 + K * N + G * N * 4 + M * N * 4
    flops = 2 * M * K * N if which != "qmm4" else M * K * N
    extra = {"quantize_rows_ms": lambda: qm.quantize_rows(x)} if which == "qmm4" else {}
    for block_n in ((512, 1024, 2560) if which == "qmm2" else (2560, )):
        fn, plain = getattr(qm, which), getattr(qm, which + "_plain")
        yield (f"{M}x{K}x{N} block_n {block_n}",
               lambda fn=fn, b=block_n: fn(x, qw, sc, block_n=b),
               lambda plain=plain, b=block_n: plain(x, qw, sc, block_n=b),
               library, nbytes, flops, extra)


def micro_planted_faults(torch, dev):
    """The microbench kernels' gates against two faults planted in the kernel
    (``qmm_microbench._plant``) on the bench's layer; either passing its gate
    ends the run:
    1. group 1 dropped from the first strip's walk: qmm2's gate (MICRO_TOL,
       2^-16 of max|plain|) must fail;
    2. the groups' scaled products summed in reverse order: qmm4's bitwise
       gate must fail.
    Launches here are not the main path's."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    (label, kern, plain, *_), = [c for c in micro_cases(torch, gen, dev, "qmm2") if "2560" in c[0]]
    (_, kern4, plain4, *_), = list(micro_cases(torch, gen, dev, "qmm4"))
    for plant, which, fn, ref_fn in ((1, "qmm2", kern, plain), (2, "qmm4", kern4, plain4)):
        ref = ref_fn()
        qm._plant = plant
        try:
            bad = fn()
            torch.cuda.synchronize()
        finally:
            qm._plant = 0
        err, tol = float((bad - ref).abs().max()), MICRO_TOL[which] * float(ref.abs().max())
        differ = int((bad != ref).sum())
        caught = err > tol if MICRO_TOL[which] else differ > 0
        what = ("group 1 dropped from the first strip's walk" if plant == 1
                else "the groups summed in reverse order")
        log(f"microbench planted fault {plant} ({what}), {which} [{label}]: max abs err {err:.3e} "
            f"(gate {tol:.3e}), {differ} entries differ from plain: {'caught' if caught else 'MISSED'}")
        check(caught, f"microbench planted fault {plant} ({what}) passes {which}'s gate")


# the training paths' attention: gpt2-large (B=4, H=20, T=1024, D=64) and
# llama3-8b (B=1, H=32/8, T=2048, D=128), causal
BWD_SHAPES = ((4, 20, 20, 1024, 64), (1, 32, 8, 2048, 128))
# llama3-8b on one rank of tensor parallelism 2 (16 of 32 heads, 4 of 8 kv
# heads): tp_phase's generate() prefill (B 4, prompt 128) and training (seq 2048)
TP_FLASH_SHAPES = ((4, 16, 4, 128, 128), (1, 16, 4, 2048, 128))
# llama3-8b at seq 8192 in seq_phase: sp 1 (B 1, H 32/8, T 8192), a Ulysses
# rank at sp 2 (its 16 of 32 heads, 4 of 8 kv heads, the whole sequence) and
# the ring zig-zag's causal diagonal step (a rank's two chunks, T 4096)
SEQ_FLASH_SHAPES = ((1, 32, 8, 8192, 128), (1, 16, 4, 8192, 128), (1, 32, 8, 4096, 128))


def flash_cases(torch, gen, dev):
    """The serving paths' prefill, gpt2-large (B=8, H=20, T=128, D=64) and a
    llama3-8b shape (H=32, Hkv=8, T=512, D=128), and the training paths'
    shapes (``BWD_SHAPES``), where the online softmax spans 16 to 32 KV
    tiles, tp 2 ranks' (``TP_FLASH_SHAPES``) and the seq phase's
    (``SEQ_FLASH_SHAPES``), up to 128 KV tiles a row."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain, \
        flash_attention_with_lse
    for B, H, Hkv, T, D in ((8, 20, 20, 128, 64), (4, 32, 8, 512, 128)) + BWD_SHAPES + TP_FLASH_SHAPES \
            + SEQ_FLASH_SHAPES:
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
    shapes (``BWD_SHAPES``, ``SEQ_FLASH_SHAPES``). Plain: the whole plain
    backward (it computes dq, dk and dv together). Library:
    scaled_dot_product_attention forward + backward; ``port_fwd_bwd_ms`` is
    the port's forward + backward kernels through autograd, the
    like-for-like yardstick of it."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (_group_sum, flash_attention,
                                                         flash_attention_bwd_plain, flash_bwd_dkv,
                                                         flash_bwd_dq)
    for B, H, Hkv, T, D in BWD_SHAPES + SEQ_FLASH_SHAPES:
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


# ring attention's off-diagonal steps at llama3-8b, seq 8192 over sp 2
# (zig-zag chunks of c = 2048): from a rank behind, q 2c x kv c; from a rank
# ahead, q c x kv 2c; non-causal
RING_SHAPES = ((1, 32, 8, 4096, 2048, 128), (1, 32, 8, 2048, 4096, 128))


def ring_flash_cases(torch, gen, dev):
    """The flash forward at the ring's non-causal rectangular shapes."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain, flash_attention_with_lse
    for B, H, Hkv, T, Tk, D in RING_SHAPES:
        q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Hkv, Tk, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, Tk, D), generator=gen, device=dev).to(torch.bfloat16)
        pairs = B * H * T * Tk
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + B * H * T * 4
        yield (f"full B={B} H={H} Hkv={Hkv} T={T} Tk={Tk} D={D}",
               lambda q=q, k=k, v=v: flash_attention_with_lse(q, k, v, causal=False),
               lambda q=q, k=k, v=v: flash_attention_plain(q, k, v, causal=False),
               lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
               nbytes, 4 * D * pairs)


def ring_bwd_cases(torch, gen, dev, which):
    """The backward kernel ``which`` at the ring's shapes, on the plain
    forward's residuals, with a random lse cotangent (the ring's merge
    passes one back) folded into delta."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (_group_sum, flash_attention, flash_attention_bwd_plain,
                                                         flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)
    for B, H, Hkv, T, Tk, D in RING_SHAPES:
        q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Hkv, Tk, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, Tk, D), generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        g_lse = torch.randn((B, H, T), generator=gen, device=dev)
        out, lse = flash_attention_plain(q, k, v, causal=False)
        delta = (do.float() * out.float()).sum(-1) - g_lse
        pairs = B * H * T * Tk
        in_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * B * H * T * 4
        args = (q, k, v, out, lse, do)
        if which == "dq":
            kern = lambda q=q, k=k, v=v, do=do, lse=lse, d=delta: flash_bwd_dq(q, k, v, do, lse, d, causal=False)
            plain = lambda a=args, g=g_lse: flash_attention_bwd_plain(*a, causal=False, g_lse=g)[0]
            nbytes, flops = in_bytes + q.numel() * 2, 6 * D * pairs
        else:
            kern = lambda q=q, k=k, v=v, do=do, lse=lse, d=delta, n=Hkv: tuple(
                _group_sum(x, n) for x in flash_bwd_dkv(q, k, v, do, lse, d, causal=False))
            plain = lambda a=args, g=g_lse: flash_attention_bwd_plain(*a, causal=False, g_lse=g)[1:]
            nbytes, flops = in_bytes + 2 * k.numel() * 2, 8 * D * pairs
        library = lambda q=q, k=k, v=v, do=do: _fwd_bwd(
            torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, enable_gqa=True), q, k, v, do)
        port = lambda q=q, k=k, v=v, do=do: _fwd_bwd(
            torch, lambda a, b, c: flash_attention(a, b, c, causal=False), q, k, v, do)
        yield (f"full B={B} H={H} Hkv={Hkv} T={T} Tk={Tk} D={D}, lse cotangent", kern, plain, library, nbytes,
               flops, {"port_fwd_bwd_ms": port})


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


def _planted(torch, gen, leaves, keep, int8):
    """The caches (k, v, scales) with NaN (int8: NaN scales, random K/V
    bytes) and with zeros at every (pool row, offset) that ``keep`` (Np, S)
    does not mark."""
    k, v, sc = leaves
    m = keep[:, None, :, None]
    zeroed = (k.masked_fill(~m, 0), v.masked_fill(~m, 0), None if sc is None else sc.masked_fill(~m, 0))
    if int8:
        noise = torch.randint(-128, 128, k.shape, generator=gen, device=k.device, dtype=torch.int8)
        return (torch.where(m, k, noise), torch.where(m, v, noise),
                sc.masked_fill(~m, float("nan"))), zeroed
    return (k.masked_fill(~m, float("nan")), v.masked_fill(~m, float("nan")), None), zeroed


def decode_invariance(torch, dev):
    """The decode kernel's bitwise invariants on the card, at gpt2-large's
    heads (D 64) and llama3-8b's (D 128, GQA g=4), bf16 and int8 KV; any
    failure ends the run:
    1. every live column c of a paged span call (T = 64) equals the paged
       decode call for a row with the same window, at the PAGED_SHAPES pools
       (the long llama pool's columns cross 512-position chunk boundaries);
    2. chains of 11 extents of S = 100 (no multiple of the 64-position tile)
       whose windows end at 511/512/513 and 1023/1024/1025 equal one slot of
       1100 rows, decode and span (T = 64, columns across the boundary); on
       the same chains, every column of a lossy extent span call equals the
       extent decode call with its window and hole;
    3. NaN planted in every cache position that no window keeps (past the
       ends, in a lossy hole, in the pool row of a dead row, in unnamed pool
       rows) changes no bit of any of the five modes.
    (The identity table == paged gate runs in ``extent_cases``.)"""
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, extent_paged_decode_attention, extent_paged_span_attention,
        paged_decode_attention, paged_span_attention)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    T, n = 64, 0
    pick = lambda t, i: None if t is None else t[i]  # noqa: E731
    for int8 in (False, True):
        for label, B, H, nkv, S, D in PAGED_SHAPES:
            q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
            kc, vc, sc, _ = _paged_kv(torch, gen, dev, B, nkv, S, D, int8)
            base = torch.tensor(SPAN_BASES[label], dtype=torch.int32, device=dev)
            start = torch.zeros((B, ), dtype=torch.int32, device=dev)
            span = paged_span_attention(q, kc, vc, start, base, k_scale=sc, v_scale=sc)
            for c in range(T):
                live = (base + 1 + c <= S).nonzero()[:, 0]
                dec = paged_decode_attention(q[live, :, c].contiguous(), kc[live], vc[live], start[live],
                                             base[live] + 1 + c, k_scale=pick(sc, live),
                                             v_scale=pick(sc, live))
                check(torch.equal(span[live, :, c], dec),
                      f"decode invariance [{label} int8={int8}]: span column {c} differs from decode")
                n += 1
        for label, H, nkv, D in (("gpt2-large", 20, 20, 64), ("llama3-8b", 32, 8, 128)):
            S, E, ends_l = 100, 11, [511, 512, 513, 1023, 1024, 1025]
            B = len(ends_l)
            kc, vc, sc, _ = _paged_kv(torch, gen, dev, B * E, nkv, S, D, int8)
            chain = torch.randperm(B * E, generator=gen, device=dev).reshape(B, E).to(torch.int32)
            big = [None if t is None else t[chain.long()].transpose(1, 2)
                   .reshape(B, t.shape[1], E * S, t.shape[3]).contiguous() for t in (kc, vc, sc)]
            start = torch.tensor([0, 3, 0, 600, 0, 0], dtype=torch.int32, device=dev)
            ends = torch.tensor(ends_l, dtype=torch.int32, device=dev)
            q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
            q1 = q[:, :, 0].contiguous()
            check(torch.equal(extent_paged_decode_attention(q1, kc, vc, start, ends, chain, k_scale=sc,
                                                            v_scale=sc),
                              paged_decode_attention(q1, big[0], big[1], start, ends, k_scale=big[2],
                                                     v_scale=big[2], block_kv=S)),
                  f"decode invariance [{label} int8={int8}]: chained decode differs from one big slot")
            check(torch.equal(extent_paged_span_attention(q, kc, vc, start, ends - 32, chain, k_scale=sc,
                                                          v_scale=sc),
                              paged_span_attention(q, big[0], big[1], start, ends - 32, k_scale=big[2],
                                                   v_scale=big[2], block_kv=S)),
                  f"decode invariance [{label} int8={int8}]: chained span differs from one big slot")
            n += 2
            # lossy rows over the same chains: every column of an extent span
            # call equals the extent decode call with its window and hole (each
            # column's hole [sink, end - window) ends elsewhere: across the
            # 512 boundary, over the dropped extents 0..6 of row 1, empty
            # while end - window < sink, in the first tile)
            lchain = chain.clone()
            lchain[1, :7] = -1
            lbase = torch.tensor([700, 1000, 900, 600, 1030, 0], dtype=torch.int32, device=dev)
            lossy = {"sink": torch.tensor([10, 0, 0, 500, 64, 4], dtype=torch.int32, device=dev),
                     "window": torch.tensor([220, 300, 0, 50, 1024, 2], dtype=torch.int32, device=dev)}
            span = extent_paged_span_attention(q, kc, vc, start, lbase, lchain, k_scale=sc, v_scale=sc,
                                               **lossy)
            for c in range(T):
                dec = extent_paged_decode_attention(q[:, :, c].contiguous(), kc, vc, start, lbase + 1 + c,
                                                    lchain, k_scale=sc, v_scale=sc, **lossy)
                check(torch.equal(span[:, :, c], dec), f"decode invariance [{label} int8={int8}]: lossy "
                      f"extent span column {c} differs from extent decode")
                n += 1
            # NaN outside every window: paged rows 0..2, and extent rows over a
            # 6-extent table (row 0 lossy: sink 10, window 60, end 590, its
            # extents 1..4 dropped; row 1 a 3-extent chain; row 2 dead)
            Np, L = 6, 6 * S
            kc, vc, sc = kc[:Np].contiguous(), vc[:Np].contiguous(), pick(sc, slice(0, Np))
            sc = None if sc is None else sc.contiguous()
            pos, lpos = torch.arange(S, device=dev), torch.arange(L, device=dev)
            start = torch.tensor([5, 0, 0], dtype=torch.int32, device=dev)
            ends = torch.tensor([70, 100, 0], dtype=torch.int32, device=dev)
            base = torch.tensor([20, 90, 0], dtype=torch.int32, device=dev)
            table = [[3, -1, -1, -1, -1, 1], [0, 2, 5, -1, -1, -1], [4, -1, -1, -1, -1, -1]]
            ext = torch.tensor(table, dtype=torch.int32, device=dev)
            x_end = torch.tensor([590, 250, 0], dtype=torch.int32, device=dev)
            x_base = (x_end - 1).clamp(min=0)
            zero3 = torch.zeros((3, ), dtype=torch.int32, device=dev)
            lossy = {"sink": torch.tensor([10, 0, 0], dtype=torch.int32, device=dev),
                     "window": torch.tensor([60, 0, 0], dtype=torch.int32, device=dev)}
            rows3 = torch.zeros((3, S), dtype=torch.bool, device=dev)

            def pool_keep(col_ends):
                keep = torch.zeros((Np, S), dtype=torch.bool, device=dev)
                for b in range(3):
                    for end in col_ends[b]:
                        k = lpos < end
                        if b == 0:
                            k &= (lpos < 10) | (lpos >= end - 60)
                        for e, prow in enumerate(table[b]):
                            if prow >= 0:
                                keep[prow] |= k[e * S:(e + 1) * S]
                return keep

            q1, q8 = q[:Np, :, 0].contiguous(), q[:Np, :, :8].contiguous()
            first3 = lambda t: None if t is None else t[:3]  # noqa: E731
            modes = [
                ("paged decode", (pos >= start[:, None]) & (pos < ends[:, None]),
                 lambda k, v, s: paged_decode_attention(q1[:3], k[:3], v[:3], start, ends,
                                                        k_scale=first3(s), v_scale=first3(s))),
                ("paged span", (pos >= start[:, None]) & (pos < base[:, None] + 8),
                 lambda k, v, s: paged_span_attention(q8[:3], k[:3], v[:3], start, base,
                                                      k_scale=first3(s), v_scale=first3(s))),
                ("extent decode", pool_keep([[int(e)] for e in x_end]),
                 lambda k, v, s: extent_paged_decode_attention(q1[:3], k, v, zero3, x_end, ext,
                                                               k_scale=s, v_scale=s, **lossy)),
                ("extent span", pool_keep([[int(e) + 1 + j for j in range(8)] for e in x_base]),
                 lambda k, v, s: extent_paged_span_attention(q8[:3], k, v, zero3, x_base, ext,
                                                             k_scale=s, v_scale=s, **lossy))]
            if not int8:
                modes.append(("decode", (pos >= start[:, None]) & (pos < ends[:, None]),
                              lambda k, v, s: decode_attention(q1[:3], k[:3], v[:3], start, ends)))
            for what, keep, call in modes:
                if keep.shape[0] == 3:
                    keep = torch.cat([keep, rows3])
                planted, zeroed = _planted(torch, gen, (kc, vc, sc), keep, int8)
                got, ref = call(*planted), call(*zeroed)
                torch.cuda.synchronize()
                check(torch.equal(got, ref) and bool(torch.isfinite(got.float()).all()),
                      f"decode invariance [{label} {what} int8={int8}]: bytes outside the windows leak")
                n += 1
    log(f"decode invariance: {n} bitwise checks passed (span column == decode, chained == one big "
        f"slot at chunk and extent boundaries, NaN outside the windows)")


def _flash_plain_keep(torch, q, k, v, keep):
    """``flash_attention_plain``'s arithmetic (default scale) with the
    (T, Tk) mask ``keep`` in place of causality: fp32 scores and softmax,
    p rounded to bf16 before P V, the row sum on the unrounded p."""
    g = q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * q.shape[-1]**-0.5
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf) / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)


def flash_planted_faults(torch, dev):
    """The flash forward's row gate against two faults of its K/V walk,
    planted through the plain version at the training shapes (``BWD_SHAPES``,
    up to T 2048); either passing the gate ends the run:
    1. one 128-key tile (keys 256..383) skipped by the rows of the second
       half, as a walk that lost a ring slot would;
    2. the ring off by one stage: tile j's V paired with tile j - 1's K
       (tile 0 with its own), as a consumer reading a stale K slot would.
    The max-abs gate's verdict is logged beside, for the record."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    for B, H, Hkv, T, D in BWD_SHAPES:
        q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, T, D), generator=gen, device=dev).to(torch.bfloat16)
        ref = flash_attention_plain(q, k, v, causal=True)[0]
        rows, cols = torch.arange(T, device=dev)[:, None], torch.arange(T, device=dev)[None, :]
        skipped = (cols <= rows) & ~((rows >= T // 2) & (cols >= 256) & (cols < 384))
        k_stale = torch.cat([k[:, :, :128], k[:, :, :-128]], dim=2)
        for what, bad in (("rows >= T/2 without keys 256..383", _flash_plain_keep(torch, q, k, v, skipped)),
                          ("ring off by one stage", flash_attention_plain(q, k_stale, v, causal=True)[0])):
            row = _row_rel_l2(torch, bad, ref)
            err, tol = float((bad.float() - ref.float()).abs().max()), 2.0**-7 * float(ref.float().abs().max())
            log(f"flash planted fault, B={B} H={H} Hkv={Hkv} T={T} D={D}, {what}: row rel L2 {row:.3e} "
                f"(gate {FLASH_ROW_REL_L2:g}), rel L2 {_rel_l2(bad, ref):.3e}, max abs err {err:.3e} "
                f"(the 2^-7 max|plain| gate {tol:.3e}: {'caught' if err > tol else 'missed'})")
            check(row > FLASH_ROW_REL_L2, f"flash planted fault, T={T} D={D}, {what}: passes the row gate")


def _flash_bwd_plain_keep(torch, q, k, v, out, lse, do, keep):
    """``flash_attention_bwd_plain``'s arithmetic (default scale, no lse
    cotangent) with the (T, Tk) mask ``keep`` in place of causality: the
    gradients of a backward whose walk skipped the pairs outside ``keep``.
    Returns (dq, dk, dv), dk/dv summed over the GQA group."""
    from deepspeed_tpu_torch.ops.flash_attention import _group_sum
    Hkv = k.shape[1]
    g, scale = q.shape[1] // Hkv, q.shape[-1]**-0.5
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(-1, keepdim=True)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))[..., None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(keep, torch.exp(s - lse), torch.zeros_like(s))
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof).to(v.dtype)
    return dq, _group_sum(dk, Hkv), _group_sum(dv, Hkv)


def flash_bwd_planted_faults(torch, dev):
    """The flash backward's row gate against three faults of its walks,
    planted through the plain version at the training shapes
    (``BWD_SHAPES``); any of them passing the gate ends the run:
    1. dq: one 64-key K/V tile of the dq kernel (keys 256..319) skipped by
       the rows of the second half, as a walk that lost a ring slot would;
    2. dk/dv: one 64-row q tile (rows 256..319) skipped by the first four
       64-row kv tiles;
    3. dk/dv: the ring off by one stage, tile j's dO (with its lse and
       delta) paired with tile j - 1's Q (tile 0 with its own), as a
       consumer reading a stale Q slot would.
    The max-abs gate's verdict is logged beside, for the record."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for B, H, Hkv, T, D in BWD_SHAPES:
        q, k, v, do, out, lse, _ = _bwd_inputs(torch, gen, dev, B, H, Hkv, T, D)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do)
        rows, cols = torch.arange(T, device=dev)[:, None], torch.arange(T, device=dev)[None, :]
        causal = cols <= rows
        no_tile = causal & ~((rows >= T // 2) & (cols >= 256) & (cols < 320))
        no_q_tile = causal & ~((rows >= 256) & (rows < 320) & (cols < 256))
        q_stale = torch.cat([q[:, :, :64], q[:, :, :-64]], dim=2)
        faults = (("dq rows >= T/2 without keys 256..319", (0, ),
                   _flash_bwd_plain_keep(torch, q, k, v, out, lse, do, no_tile)),
                  ("dk/dv kv rows < 256 without q rows 256..319", (1, 2),
                   _flash_bwd_plain_keep(torch, q, k, v, out, lse, do, no_q_tile)),
                  ("dk/dv ring off by one stage", (1, 2),
                   flash_attention_bwd_plain(q_stale, k, v, out, lse, do)))
        for what, outputs, bad in faults:
            for i in outputs:
                tag = ("dq", "dk", "dv")[i]
                row = _bwd_row_rel_l2(torch, bad[i], ref[i])
                err = float((bad[i].float() - ref[i].float()).abs().max())
                tol = 2.0**-7 * float(ref[i].float().abs().max())
                log(f"flash bwd planted fault, B={B} H={H} Hkv={Hkv} T={T} D={D}, {what}, {tag}: row rel "
                    f"L2 {row:.3e} (gate {FLASH_BWD_ROW_REL_L2:g}), rel L2 {_rel_l2(bad[i], ref[i]):.3e}, "
                    f"max abs err {err:.3e} (the 2^-7 max|plain| gate {tol:.3e}: "
                    f"{'caught' if err > tol else 'missed'})")
                check(row > FLASH_BWD_ROW_REL_L2,
                      f"flash bwd planted fault, T={T} D={D}, {what}, {tag}: passes the row gate")


def _paged_plain_p_bf16(torch, q, kc, vc, ends, sc):
    """Paged decode (start 0) as the kernel would compute it if P V dropped
    p's bf16 low part: p (times each position's V scale on the int8 tier)
    rounded to bf16 before the product, the rest as the plain version."""
    B, H, D = q.shape
    nkv, S = kc.shape[1], kc.shape[2]
    qg = q.reshape(B, nkv, H // nkv, D).float() * D**-0.5
    k, v = kc.float(), vc.float()
    if sc is not None:
        k = k * sc.float()
    s = qg @ k.transpose(-1, -2)  # (B, nkv, g, S)
    live = torch.arange(S, device=q.device)[None, :] < ends[:, None]
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True)
    pv = p if sc is None else p * sc.float().transpose(-1, -2)
    out = (pv.to(torch.bfloat16).float() @ v) / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, D).to(torch.bfloat16)


def decode_planted_faults(torch, dev):
    """The decode kernel's relative-L2 gates against two planted faults;
    either passing its gate ends the run:
    1. one 512-position chunk skipped in the merge, made by the kernel itself:
       the extent modes over an identity table with a lossy hole that is
       exactly one chunk (chunk 3 of row 0's 8 at the long llama3-8b pool,
       decode and span; chunk 7 of 16 of the 8000-position chain), against
       the plain version of the whole window: DECODE_ROW_REL_L2 must catch it;
    2. p's bf16 low part dropped from P V (``_paged_plain_p_bf16``, the
       kernel's arithmetic with that fault, in PyTorch) at the paged decode
       pools, bf16 and int8: DECODE_REL_L2 must catch it."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        extent_paged_decode_attention, extent_paged_decode_attention_plain,
        extent_paged_span_attention, paged_decode_attention_plain, paged_span_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731

    def report(what, bad, ref, gate):
        rel, row = _rel_l2(bad, ref), _row_rel_l2(torch, bad, ref)
        err, tol = float((bad.float() - ref.float()).abs().max()), 2.0**-7 * float(ref.float().abs().max())
        log(f"decode planted fault, {what}: row rel L2 {row:.3e} (gate {DECODE_ROW_REL_L2:g}), rel L2 "
            f"{rel:.3e} (gate {DECODE_REL_L2:g}), max abs err {err:.3e} (the 2^-7 max|plain| gate "
            f"{tol:.3e}: {'caught' if err > tol else 'missed'})")
        caught = row > DECODE_ROW_REL_L2 if gate == "row" else rel > DECODE_REL_L2
        check(caught, f"decode planted fault, {what}: passes the {gate} rel L2 gate")

    label, B, H, nkv, S, D = PAGED_SHAPES[2]
    kc, vc, _, _ = _paged_kv(torch, gen, dev, B, nkv, S, D, False)
    start, ends, base = i32([0] * B), i32(PAGED_ENDS[label]), i32(SPAN_BASES[label])
    ident = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    bad = extent_paged_decode_attention(q, kc, vc, start, ends, ident, sink=i32([1536, 0, 0, 0]),
                                        window=i32([2048, 0, 0, 0]))
    report(f"{label} decode, row 0 (end 4096) without chunk 3", bad,
           paged_decode_attention_plain(q, kc, vc, start, ends), "row")
    q = torch.randn((B, H, 64, D), generator=gen, device=dev).to(torch.bfloat16)
    bad = extent_paged_span_attention(q, kc, vc, start, base, ident, sink=i32([1536, 0, 0, 0]),
                                      window=i32([1953, 0, 0, 0]))
    report(f"{label} span, row 0 (base 4000) without [1536, 2048 + c)", bad,
           paged_span_attention_plain(q, kc, vc, start, base), "row")
    N, H, nkv, S, D, E = EXT_SHAPES[0][1:]
    table, ends_l, _, _ = _ext_layout(N, E, "chain")
    kc, vc, _, _ = _paged_kv(torch, gen, dev, N, nkv, S, D, False)
    ext, ends, start = i32(table), i32(ends_l), i32([0] * N)
    q = torch.randn((N, H, D), generator=gen, device=dev).to(torch.bfloat16)
    hole = {"sink": i32([7 * 512] + [0] * (N - 1)), "window": i32([ends_l[0] - 8 * 512] + [0] * (N - 1))}
    bad = extent_paged_decode_attention(q, kc, vc, start, ends, ext, **hole)
    report("llama3-8b chain decode, row 0 (end 8000) without chunk 7 of 16", bad,
           extent_paged_decode_attention_plain(q, kc, vc, start, ends, ext), "row")
    for int8 in (False, True):
        for label, B, H, nkv, S, D in PAGED_SHAPES[:1 if int8 else 3]:
            kc, vc, sc, _ = _paged_kv(torch, gen, dev, B, nkv, S, D, int8)
            start, ends = i32([0] * B), i32(PAGED_ENDS[label])
            q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
            report(f"{label} decode int8={int8}, p's bf16 low part dropped",
                   _paged_plain_p_bf16(torch, q, kc, vc, ends, sc),
                   paged_decode_attention_plain(q, kc, vc, start, ends, k_scale=sc, v_scale=sc), "whole")


def _paged_kv(torch, gen, dev, B, nkv, S, D, int8):
    """A slot pool's K/V: bf16, or int8 with the port's per-row scales."""
    from deepspeed_tpu_torch.ops.quantizer import quantize_kv_rows
    k = torch.randn((B, nkv, S, D), generator=gen, device=dev) * 2
    v = torch.randn((B, nkv, S, D), generator=gen, device=dev) * 2
    if int8:
        kq, vq, sc = quantize_kv_rows(k, v)
        deq = ((kq.float() * sc.float()).to(torch.bfloat16), (vq.float() * sc.float()).to(torch.bfloat16))
        return kq, vq, sc, deq
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return k, v, None, (k, v)


# the scheduler's pool at gpt2-large (8 slots, 20 heads of 64, S=512), a
# llama3-8b pool (4 slots, 32 q and 8 kv heads of 128) and a long llama3-8b
# pool (S=4096: windows over several of the kernel's 512-position chunks)
PAGED_SHAPES = [("gpt2-large", 8, 20, 20, 512, 64), ("llama3-8b", 4, 32, 8, 512, 128),
                ("llama3-8b long", 4, 32, 8, 4096, 128)]
# the llama3-8b pool on one rank of tensor parallelism 2 (16 q and 4 kv heads),
# bf16 and int8 KV
PAGED_TP2 = ("llama3-8b tp 2 rank", 4, 16, 4, 512, 128)
# the seq-parallel prefill on one rank of seq 2 (seq_phase's stream: 4 slots
# of 1024, a 128-column wide chunk split in two): rank 1's 64 columns of a
# 768-token prompt's chunk at 640, beside three rows carried at T = 64
PAGED_SEQ2 = ("llama3-8b seq 2 rank", 4, 32, 8, 1024, 128)
PAGED_ENDS = {"gpt2-large": [300, 0, 129, 511, 64, 0, 257, 400], "llama3-8b": [130, 290, 511, 64],
              "llama3-8b long": [4096, 1023, 2600, 3001], "llama3-8b tp 2 rank": [130, 290, 511, 64]}
SPAN_BASES = {"gpt2-large": [128, 300, 17, 440, 200, 64, 380, 240], "llama3-8b": [128, 0, 300, 440],
              "llama3-8b long": [4000, 480, 1500, 3000], "llama3-8b tp 2 rank": [128, 0, 300, 440],
              "llama3-8b seq 2 rank": [704, 310, 45, 0]}


def _paged_bytes(torch, q, nkv, D, windows, int8):
    """Bytes the paged modes must move: q in, out back, each row's window
    of K and V once (plus 2 bytes a row of scales on the int8 tier), the
    (B,) window bounds."""
    rows = int(sum(windows))
    return 2 * q.numel() * 2 + rows * nkv * D * 2 * (1 if int8 else 2) + (2 * rows if int8 else 0) \
        + 2 * len(windows) * 4


def paged_decode_cases(torch, gen, dev, int8):
    """Paged decode over the scheduler's pool at gpt2-large (ragged ends,
    two dead slots) and llama3-8b (GQA g=4, D=128). Library:
    scaled_dot_product_attention with the per-row boolean mask over the
    dequantized cache (dead rows give NaN there, unread)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import (paged_decode_attention,
                                                          paged_decode_attention_plain)
    for label, B, H, nkv, S, D in PAGED_SHAPES[:1 if int8 else 3] + [PAGED_TP2]:
        q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc, sc, (kd, vd) = _paged_kv(torch, gen, dev, B, nkv, S, D, int8)
        ends = torch.tensor(PAGED_ENDS[label], dtype=torch.int32, device=dev)
        starts = torch.zeros((B, ), dtype=torch.int32, device=dev)
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] < ends[:, None])[:, None, None, :]
        nbytes = _paged_bytes(torch, q, nkv, D, ends.tolist(), int8)
        live = int(ends.sum())
        yield (f"{label} decode B={B} H={H}/{nkv} S={S} D={D} ends {ends.tolist()}",
               lambda a=(q, kc, vc, starts, ends), sc=sc: paged_decode_attention(
                   *a, k_scale=sc, v_scale=sc),
               lambda a=(q, kc, vc, starts, ends), sc=sc: paged_decode_attention_plain(
                   *a, k_scale=sc, v_scale=sc),
               lambda q=q, kd=kd, vd=vd, m=mask, g=H != nkv: F.scaled_dot_product_attention(
                   q[:, :, None], kd, vd, attn_mask=m, enable_gqa=g),
               nbytes, 4 * H * D * live)


def paged_span_cases(torch, gen, dev, int8):
    """Paged span at the scheduler's chunk step: gpt2-large (one row
    prefilling 64 columns at base 128, seven decode rows carried at T=64)
    and llama3-8b (T=64, GQA g=4, D=128). Every column is computed, as on
    the TPU, so the operations count each column's window. Library:
    scaled_dot_product_attention with the per-row, per-column mask."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import (paged_span_attention,
                                                          paged_span_attention_plain)
    T = 64
    for label, B, H, nkv, S, D in PAGED_SHAPES[:1 if int8 else 3] + [PAGED_TP2] + ([] if int8 else [PAGED_SEQ2]):
        q = torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc, sc, (kd, vd) = _paged_kv(torch, gen, dev, B, nkv, S, D, int8)
        base = torch.tensor(SPAN_BASES[label], dtype=torch.int32, device=dev)
        starts = torch.zeros((B, ), dtype=torch.int32, device=dev)
        col_end = (base[:, None] + 1 + torch.arange(T, device=dev)[None, :]).clamp(max=S)  # (B, T)
        pos = torch.arange(S, device=dev)
        mask = (pos[None, None, :] < col_end[:, :, None])[:, None]  # (B, 1, T, S)
        windows = (base + T).clamp(max=S).tolist()
        nbytes = _paged_bytes(torch, q, nkv, D, windows, int8)
        pairs = int(col_end.sum()) * H
        yield (f"{label} span B={B} H={H}/{nkv} T={T} S={S} D={D} bases {base.tolist()}",
               lambda a=(q, kc, vc, starts, base), sc=sc: paged_span_attention(
                   *a, k_scale=sc, v_scale=sc),
               lambda a=(q, kc, vc, starts, base), sc=sc: paged_span_attention_plain(
                   *a, k_scale=sc, v_scale=sc),
               lambda q=q, kd=kd, vd=vd, m=mask, g=H != nkv: F.scaled_dot_product_attention(
                   q, kd, vd, attn_mask=m, enable_gqa=g),
               nbytes, 4 * D * pairs)


# the long-context pool (extent chains): llama3-8b's (16 rows of 1024, 8 kv
# heads of 128, GQA g=4, chains of up to 8 extents: its 8192 horizon) and
# gpt2-large's (8 rows of 512, 20 heads of 64, 2 extents: its 1024 horizon)
EXT_SHAPES = [("llama3-8b", 16, 32, 8, 1024, 128, 8), ("gpt2-large", 8, 20, 20, 512, 64, 2)]


def _ext_layout(N, E, layout):
    """(table (N, E), ends (N,), sinks, windows) of a pool of N rows for
    ``layout``: "chain", row 0 a chain over shuffled pool rows (ending at
    8000 of 8192 on llama's pool, 900 of 1024 on gpt2-large's), the rows
    outside it one extent each (one of them dead, ends 0), the chain's other
    rows dead dispatch rows; "lossy", row 0's chain with a 64-token sink and
    a 1024-token window, the five extents wholly in its hole dropped (-1)
    and their pool rows holding other rows' single extents; "identity",
    every row its own pool row, E = 1."""
    if layout == "identity":
        return [[b] for b in range(N)], [700, 1024, 33, 512, 0, 900, 250, 1000, 300, 1024, 64,
                                         800, 450, 0, 990, 17][:N], None, None
    if N == 8:  # gpt2-large
        return ([[0, 5], [1, -1], [2, -1], [3, -1], [4, -1], [5, -1], [6, -1], [7, -1]],
                [900, 300, 0, 129, 511, 0, 64, 400], None, None)
    table = [[b] + [-1] * (E - 1) for b in range(N)]
    ends = [0] * N
    for b, e in zip((1, 4, 6, 8, 10, 11, 13, 15), (700, 1024, 33, 512, 0, 900, 250, 1000)):
        ends[b] = e
    if layout == "chain":
        table[0] = [0, 9, 3, 12, 5, 14, 7, 2]
        return table, [8000] + ends[1:], None, None
    table[0] = [0, -1, -1, -1, -1, -1, 7, 2]
    for b, e in zip((9, 3, 12, 5, 14), (300, 1024, 64, 800, 450)):
        ends[b] = e
    sinks, wins = [0] * N, [0] * N
    sinks[0], wins[0] = 64, 1024
    return table, [8000] + ends[1:], sinks, wins


def _ext_kept(torch, start, col_ends, sinks, wins, L):
    """(B, T, L) bool: the logical positions each column keeps, its window
    [start, end) less the lossy hole [sink, end - window)."""
    pos = torch.arange(L, device=col_ends.device)[None, None, :]
    end = col_ends[:, :, None]
    keep = (pos >= start[:, None, None]) & (pos < end)
    if sinks is not None:
        w = wins[:, None, None]
        keep &= (w == 0) | (pos < sinks[:, None, None]) | (pos >= end - w)
    return keep


def extent_cases(torch, gen, dev, span, int8):
    """The extent modes (``_extent_kernel``) at the long-context pool's
    shapes: llama3-8b's shuffled 8-extent chain, its lossy window with
    dropped extents, its identity table (also held bitwise against the
    paged mode), and gpt2-large's 2-extent chain (D = 64); the span at the
    chunk step's T = 64 (row 0 prefilling 64 columns up to its end, the
    other rows carried). Bytes: q in and out, each row's kept window of K
    and V once (int8: 1 byte an element and 2 bytes of scales a position),
    its table row; operations 4 * D per (query head, column, kept key).
    Library chain: the logical window gathered by index_select (and
    dequantized on the int8 tier), then one scaled_dot_product_attention
    with the per-row (and per-column) kept mask."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_attention import (
        extent_paged_decode_attention, extent_paged_decode_attention_plain,
        extent_paged_span_attention, extent_paged_span_attention_plain, paged_decode_attention,
        paged_span_attention)
    T = 64 if span else 1
    layouts = [("llama3-8b", "chain"), ("llama3-8b", "lossy"), ("llama3-8b", "identity"),
               ("gpt2-large", "chain")]
    shapes = {lb: sh for lb, *sh in EXT_SHAPES}
    for label, layout in layouts[:3] if int8 else layouts:
        N, H, nkv, S, D, E = shapes[label]
        table, ends_l, sinks_l, wins_l = _ext_layout(N, E, layout)
        ext = torch.tensor(table, dtype=torch.int32, device=dev)
        E_t = ext.shape[1]
        kc, vc, sc, (kd, vd) = _paged_kv(torch, gen, dev, N, nkv, S, D, int8)
        ends = torch.tensor(ends_l, dtype=torch.int32, device=dev)
        starts = torch.zeros((N, ), dtype=torch.int32, device=dev)
        lossy = {} if sinks_l is None else {
            "sink": torch.tensor(sinks_l, dtype=torch.int32, device=dev),
            "window": torch.tensor(wins_l, dtype=torch.int32, device=dev)}
        L = E_t * S
        if span:
            base = (ends - T).clamp(min=0)
            base[1:] = (ends[1:] - 1).clamp(min=0)  # carried decode rows
            col_ends = (base[:, None] + 1 + torch.arange(T, device=dev)[None, :])
            q = torch.randn((N, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
            args = (q, kc, vc, starts, base, ext)
            kern_fn, plain_fn, paged_fn = (extent_paged_span_attention,
                                           extent_paged_span_attention_plain, paged_span_attention)
        else:
            col_ends = ends[:, None]
            q = torch.randn((N, H, D), generator=gen, device=dev).to(torch.bfloat16)
            args = (q, kc, vc, starts, ends, ext)
            kern_fn, plain_fn, paged_fn = (extent_paged_decode_attention,
                                           extent_paged_decode_attention_plain,
                                           paged_decode_attention)
        keep = _ext_kept(torch, starts, col_ends, lossy.get("sink"), lossy.get("window"), L)
        if layout == "identity":
            out = kern_fn(*args, k_scale=sc, v_scale=sc)
            ref = paged_fn(*args[:5], k_scale=sc, v_scale=sc)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"extent {'span' if span else 'decode'} [{label} identity "
                  f"table, int8={int8}]: differs from the paged mode")
        rows_kept = int(keep.any(1).sum())
        nbytes = 2 * q.numel() * 2 + rows_kept * nkv * D * 2 * (1 if int8 else 2) \
            + (2 * rows_kept if int8 else 0) + ext.numel() * 4 + 2 * N * 4
        pairs = int(keep.sum()) * H
        idx = ext.clamp(min=0).long().reshape(-1)
        mask = keep[:, None]  # (N, 1, T, L)

        def chain(q=q, idx=idx, mask=mask, kc=kc, vc=vc, sc=sc, N=N, nkv=nkv, S=S, D=D, E_t=E_t,
                  g=H != nkv, span=span):
            def logical(leaf):
                return leaf.index_select(0, idx).reshape(N, E_t, *leaf.shape[1:]).transpose(1, 2) \
                    .reshape(N, leaf.shape[1], E_t * S, leaf.shape[3])
            kl, vl = logical(kc), logical(vc)
            if sc is not None:
                s = logical(sc)
                kl = (kl.float() * s.float()).to(torch.bfloat16)
                vl = (vl.float() * s.float()).to(torch.bfloat16)
            return F.scaled_dot_product_attention(q if span else q[:, :, None], kl, vl, attn_mask=mask,
                                                  enable_gqa=g)

        desc = (f"{label} {layout} {'span T=64' if span else 'decode'} N={N} H={H}/{nkv} S={S} "
                f"D={D} E={E_t} ends {ends_l[:4]}...")
        yield (desc,
               lambda a=args, sc=sc, lk=lossy, f=kern_fn: f(*a, k_scale=sc, v_scale=sc, **lk),
               lambda a=args, sc=sc, lk=lossy, f=plain_fn: f(*a, k_scale=sc, v_scale=sc, **lk),
               chain, nbytes, 4 * D * pairs)


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
                ("llama3-8b", 4, 4096, 32, 8, 128, 14336, "swiglu", "rmsnorm", True),
                ("gpt2-large chunk step", CHUNK_M, 1280, 20, 20, 64, 5120, "gelu", "layernorm", False)]
# llama3-8b's chunk step (4 slots x 64 columns), kernels A and C
LLAMA_CHUNK = ("llama3-8b chunk step", 256, 4096, 32, 8, 128, 14336, "swiglu", "rmsnorm", True)
# the scheduler's verify width at gpt2-large (8 slots x (1 + 4 drafts)): the
# first width of kernel C on the wgmma path
VERIFY = ("gpt2-large verify", 40, 1280, 20, 20, 64, 5120, "gelu", "layernorm", False)
# kernels A and C's rows are also held to a relative L2 error each (the
# outputs of one token): max|plain| is set by the largest rows, so the
# max-abs gate alone could pass a row that lost a segment of K
BLOCK_ROW_REL_L2 = 2.0**-6
BLOCK_KERNELS = ("fused_qkv_ln", "fused_out_mlp")
# the rows whose bits must not depend on M: every path and tile edge of
# kernels A and C (mma.sync to 32, wgmma on 64-row tiles with K split over
# blocks, and on 64- or 128-row tiles with the chain in registers)
BLOCK_INVARIANT_M = (1, 4, 8, 16, 32, 33, 40, 64, 256, 512)


def qkv_ln_cases(torch, gen, dev):
    """Kernel A at gpt2-large's decode layer (B=8, H=1280, 20 heads of 64,
    layernorm) and llama3-8b's (B=4, H=4096, 32 q and 8 kv heads of 128,
    rmsnorm, RoPE), and at the chunk steps (gpt2-large M=512, llama3-8b
    M=256). Library: layer_norm/rms_norm + torch.matmul on the dequantized
    bf16 weight + bias (+ RoPE in torch ops), a chain of calls; beside it
    ``product_ms``, quant_matmul alone on the normalized rows."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_block import _norm, fused_qkv_ln, fused_qkv_ln_plain
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    for label, B, H, nh, nkv, hd, _, _, norm, rope in LAYER_SHAPES + [LLAMA_CHUNK]:
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

        # the product alone (quant_matmul on the normalized rows): the norm
        # pass and the epilogue are the rest of the call
        xn = _norm(x.float(), norms, 0, norm, 1e-5).to(torch.bfloat16)
        yield (f"{label} B={B} H={H} N={N}{' rope' if rope else ''} {norm}",
               lambda x=x, n=norms, p=qkv, r=rope_op, nm=norm: fused_qkv_ln(x, n, p, norm=nm, rope=r),
               lambda x=x, n=norms, p=qkv, r=rope_op, nm=norm: fused_qkv_ln_plain(x, n, p, norm=nm,
                                                                                   rope=r),
               chain, nbytes, 2 * B * H * N,
               {"product_ms": lambda xn=xn, p=qkv: quant_matmul(xn, p[0], p[1])})


def out_mlp_cases(torch, gen, dev):
    """Kernel C at gpt2-large's decode layer (B=8, H=1280, F=5120, gelu,
    layernorm) and llama3-8b's (B=4, H=4096, F=14336, swiglu, rmsnorm), at
    the chunk steps (gpt2-large M=512, llama3-8b M=256) and at gpt2-large's
    verify width (M=40).
    Library: the chain torch.matmul + bias + residual, layer_norm/rms_norm,
    torch.matmul (x2 gated) + bias + activation, torch.matmul + bias +
    residual, on the dequantized bf16 weights."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.decode_block import fused_out_mlp, fused_out_mlp_plain
    for label, B, H, nh, nkv, hd, F_, act, norm, _ in LAYER_SHAPES + [LLAMA_CHUNK, VERIFY]:
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


# block-sparse attention: gpt2-large's attention widths (B 2, H 20, D 64) at
# T 4096 with block 64 (BigBird, Fixed unidirectional, and Fixed at a ragged
# T), and llama3-8b's (B 1, H 32 -- the op has no GQA -- D 128) with block 16
SPARSE_T = 4096


def _sparse_kernel_shapes():
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig, FixedSparsityConfig
    fixed = lambda H, blk: FixedSparsityConfig(H, block=blk, attention="unidirectional")
    return [("gpt2-large BigBird", 2, 20, SPARSE_T, 64, BigBirdSparsityConfig(20, block=64)),
            ("gpt2-large Fixed uni", 2, 20, SPARSE_T, 64, fixed(20, 64)),
            ("llama3-8b BigBird", 1, 32, SPARSE_T, 128, BigBirdSparsityConfig(32, block=16)),
            ("gpt2-large Fixed uni ragged", 2, 20, SPARSE_T - 40, 64, fixed(20, 64))]


def _visible(torch, layout, block, T, causal, dev):
    """(1, H, T, T) bool: the layout's tiles expanded to positions, cropped
    to T, and kv <= q when causal (the function the kernels compute)."""
    m = torch.from_numpy(layout).to(dev).bool()
    m = m.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :T, :T]
    if causal:
        m = m & torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    return m[None]


def block_sparse_cases(torch, gen, dev, which):
    """The block-sparse kernel ``which`` ("fwd", "dq" or "dkv") at
    ``_sparse_kernel_shapes``. The backward kernels run on the plain
    forward's out and lse. Bound: 4, 6 or 8 * D operations per visible
    (query, key) pair of the layout, and q, k, v (+ dO, lse, delta) read
    once, the outputs written once, and of the tables the counts and the
    entries a CTA reads (``cnt`` of its row, not the padding). Library: one
    scaled_dot_product_attention with the layout expanded to a boolean
    attn_mask (forward and backward for dq and dk/dv)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        block_sparse_attention_plain, block_sparse_bwd_dkv, block_sparse_bwd_dkv_plain,
        block_sparse_bwd_dq, block_sparse_bwd_dq_plain, block_sparse_fwd, make_block_sparse_attention)
    for label, B, H, T, D, cfg in _sparse_kernel_shapes():
        blk = cfg.block
        layout = cfg.make_layout(-(-T // blk) * blk)
        causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
        attn = make_block_sparse_attention(layout, blk, causal)
        q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
        fwd_plan, dkv_plan = attn.plans
        q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        mask = _visible(torch, layout, blk, T, causal, dev)
        pairs = B * int(mask.sum())
        qkv_bytes = 3 * q.numel() * 2
        q_table_bytes = (int(q_cnt.sum()) + q_cnt.numel()) * 4
        kv_table_bytes = (int(kv_cnt.sum()) + kv_cnt.numel()) * 4
        desc = (f"{label} B={B} H={H} T={T} D={D} block={blk} density "
                f"{pairs / (B * H * T * T):.3f}{' causal' if causal else ''}")
        plan = dkv_plan if which == "dkv" else fwd_plan  # dq walks the forward's plan
        # the plan's cuts and the workspace their partials take a call
        ws = plan.workspace_floats(B, blk, {"fwd": D + 2, "dq": D, "dkv": 2 * D}[which]) * 4 / 2**20
        desc += f", {len(plan.items)} items, {len(plan.splits)} split rows, workspace {ws:.2f} MiB"
        if which == "fwd":
            yield (desc,
                   lambda a=(q, k, v, q_idx, q_cnt, blk, causal), p=plan: block_sparse_fwd(*a, plan=p),
                   lambda a=(q, k, v, q_idx, q_cnt, blk, causal), p=plan: block_sparse_attention_plain(
                       *a, plan=p),
                   lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(q, k, v, attn_mask=m),
                   qkv_bytes + q.numel() * 2 + B * H * T * 4 + q_table_bytes,
                   4 * D * pairs)
            continue
        out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, blk, causal, plan=fwd_plan)
        delta = (do.float() * out.float()).sum(-1)
        in_bytes = qkv_bytes + do.numel() * 2 + 2 * B * H * T * 4
        library = lambda q=q, k=k, v=v, do=do, m=mask: _fwd_bwd(
            torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=m), q, k, v, do)
        if which == "dq":
            args = (q, k, v, do, lse, delta, q_idx, q_cnt, blk, causal)
            yield (desc, lambda a=args, p=plan: block_sparse_bwd_dq(*a, plan=p),
                   lambda a=args, p=plan: block_sparse_bwd_dq_plain(*a, plan=p), library,
                   in_bytes + q.numel() * 2 + q_table_bytes, 6 * D * pairs)
        else:
            args = (q, k, v, do, lse, delta, kv_idx, kv_cnt, blk, causal)
            yield (desc, lambda a=args, p=plan: block_sparse_bwd_dkv(*a, plan=p),
                   lambda a=args, p=plan: block_sparse_bwd_dkv_plain(*a, plan=p), library,
                   in_bytes + 2 * k.numel() * 2 + kv_table_bytes, 8 * D * pairs)


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
    # the same three kernels at ring attention's non-causal rectangular steps
    # (the backward with an lse cotangent); their launches come from the seq phase
    ("flash_attention_ring", "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:236", ring_flash_cases, "call"),
    ("flash_bwd_dq_ring", "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:298", lambda t, g, d: ring_bwd_cases(t, g, d, "dq"), "call"),
    ("flash_bwd_dkv_ring", "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
     "deepspeed_tpu/ops/pallas/flash_attention.py:315", lambda t, g, d: ring_bwd_cases(t, g, d, "dkv"), "call"),
    # the paged, span and int8-KV modes of _decode_kernel (one CUDA kernel)
    ("paged_decode_attention", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198",
     lambda t, g, d: paged_decode_cases(t, g, d, False), "call"),
    ("paged_decode_attention_int8", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198",
     lambda t, g, d: paged_decode_cases(t, g, d, True), "call"),
    ("paged_span_attention", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198",
     lambda t, g, d: paged_span_cases(t, g, d, False), "call"),
    ("paged_span_attention_int8", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:198",
     lambda t, g, d: paged_span_cases(t, g, d, True), "call"),
    # _extent_kernel: the extent modes of the same CUDA kernel (long context)
    ("extent_paged_decode", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:367",
     lambda t, g, d: extent_cases(t, g, d, False, False), "chain"),
    ("extent_paged_decode_int8", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:367",
     lambda t, g, d: extent_cases(t, g, d, False, True), "chain"),
    ("extent_paged_span", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:367",
     lambda t, g, d: extent_cases(t, g, d, True, False), "chain"),
    ("extent_paged_span_int8", "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
     "deepspeed_tpu/ops/pallas/decode_attention.py:367",
     lambda t, g, d: extent_cases(t, g, d, True, True), "chain"),
    # block-sparse attention: forward, dq, dk/dv over the layout's tables
    ("block_sparse_fwd", "deepspeed_tpu_torch/ops/csrc/block_sparse_attention_fwd.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:216",
     lambda t, g, d: block_sparse_cases(t, g, d, "fwd"), "call"),
    ("block_sparse_bwd_dq", "deepspeed_tpu_torch/ops/csrc/block_sparse_attention_bwd.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:252",
     lambda t, g, d: block_sparse_cases(t, g, d, "dq"), "call"),
    ("block_sparse_bwd_dkv", "deepspeed_tpu_torch/ops/csrc/block_sparse_attention_bwd.cu",
     "deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:270",
     lambda t, g, d: block_sparse_cases(t, g, d, "dkv"), "call"),
    # the decode-shape microbench's three tilings (w8a16 in shared memory, in
    # registers; w8a8), the main path of which is the microbench
    ("qmm2", "deepspeed_tpu_torch/ops/csrc/qmm_microbench.cu", "benchmarks/qmm_microbench.py:107",
     lambda t, g, d: micro_cases(t, g, d, "qmm2"), "chain"),
    ("qmm3", "deepspeed_tpu_torch/ops/csrc/qmm_microbench.cu", "benchmarks/qmm_microbench.py:150",
     lambda t, g, d: micro_cases(t, g, d, "qmm3"), "chain"),
    ("qmm4", "deepspeed_tpu_torch/ops/csrc/qmm_microbench.cu", "benchmarks/qmm_microbench.py:205",
     lambda t, g, d: micro_cases(t, g, d, "qmm4"), "chain"),
]
# the microbench kernels' fp32 outputs: qmm4 bitwise its plain version
# (exact int32 partials, the same separately rounded recurrence); qmm2 and
# qmm3 within 2^-16 of max|plain| (exact products, the tensor cores' sums
# against cuBLAS fp32)
MICRO_TOL = {"qmm2": 2.0**-16, "qmm3": 2.0**-16, "qmm4": 0.0}
# kernels whose two calls on the same inputs must agree bit for bit
DETERMINISTIC = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "flash_attention_ring", "flash_bwd_dq_ring",
                 "flash_bwd_dkv_ring", "block_sparse_fwd",
                 "block_sparse_bwd_dq", "block_sparse_bwd_dkv", "qmm2", "qmm3", "qmm4")
# kernels whose fp32 output (the lse) holds -inf where a row attends nothing:
# there the kernel must give -inf too, and the finite entries are compared
NEG_INF_OUTPUTS = ("block_sparse_fwd", )
# the block-sparse outputs are also held to a relative L2 error: in a causal
# layout row 0 attends only itself and sets max|plain| several times the
# typical entry, so the max-abs gate alone could pass a dropped kv block.
# The sparse phase plants that fault and requires this gate to catch it.
SPARSE_REL_L2 = 2e-3
# the decode kernel's rows (every mode of decode_attention.cu)
DECODE_KERNELS = tuple(k[0] for k in KERNELS if k[1].endswith("/decode_attention.cu"))
# ... are also held to a relative L2 error in each folded row (the D outputs
# of one (row, query head, column)) and over the whole output: max|plain| is
# set by the short windows, so the max-abs gate alone would pass a long
# window that lost one 512-position chunk in the merge (its outputs are a
# tenth of the short rows'). ``decode_planted_faults`` plants that fault (and
# p's bf16 low part dropped) and requires these gates to catch it. The limits
# lie between the readings (PERF.md): sound rows at most 2.4e-3 a row and
# 1.4e-4 an output; a skipped chunk 0.66 a row, the low part dropped 1.8e-3
# an output.
DECODE_ROW_REL_L2 = 2.0**-6
DECODE_REL_L2 = 2.0**-11
# the flash forward's output rows (the D outputs of one (b, h, query row))
# are also held to a relative L2 error: in a causal layout row 0 attends
# only itself and sets max|plain|, so the max-abs gate alone would pass a
# long row that lost one 128-key tile or read a stale ring slot.
# ``flash_planted_faults`` plants both and requires this gate to catch them.
FLASH_ROW_REL_L2 = 2.0**-6
FLASH_FWD_ROWS = ("flash_attention", "flash_attention_ring")
# the flash backward's output rows (one (b, h, q row) of dq; one (b, kv
# head, kv row) of dk and dv) are held to a relative L2 error too, for the
# same reason: max|plain| is set by the first causal rows, so a long row
# that lost a K/V or Q/dO tile could pass the max-abs gate. A few rows'
# references nearly vanish by cancellation (dq's row 0 attends one key,
# where dp - delta is 0 but for rounding), so a row's error is taken
# against its norm or FLASH_BWD_ROW_FLOOR times the rms of the output's row
# norms, whichever is larger (``_bwd_row_rel_l2``).
# ``flash_bwd_planted_faults`` plants three faults of the walks and requires
# this gate to catch each; the limits lie between the readings (PERF.md).
# The block-sparse dq rows are held to it too: a global row that lost one
# of its 64 kv blocks in the split walks' merge moves the whole dq by only
# ~1.2e-3 relative L2, under SPARSE_REL_L2 (the global rows' dq is a small
# share of the whole); ``sparse_attention_phase`` plants that fault.
FLASH_BWD_ROW_REL_L2 = 2.0**-6
FLASH_BWD_ROW_FLOOR = 2.0**-4
FLASH_BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
ROW_GATED_BWD = FLASH_BWD_KERNELS + ("flash_bwd_dq_ring", "flash_bwd_dkv_ring", "block_sparse_bwd_dq")


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
            case_err, case_ref, case_rel, extra_rec = 0.0, 0.0, None, {}
            # outputs in bf16 (the working type): one bf16 ulp at the largest
            # magnitude, 2^-7 of max|plain|; the flash lse (fp32 on both
            # sides, online vs direct softmax) within 1e-3
            for i, (o, r) in enumerate(pairs):
                if name in NEG_INF_OUTPUTS and o.dtype == torch.float32:
                    fin = torch.isfinite(r)
                    check(torch.equal(torch.isfinite(o), fin) and bool((o[~fin] == r[~fin]).all()),
                          f"{name} [{label}] output {i}: non-finite entries differ from plain")
                    o, r = o[fin], r[fin]
                err = float((o.float() - r.float()).abs().max())
                ref_max = float(r.float().abs().max())
                tol = 1e-3 if o.dtype == torch.float32 else 2.0**-7 * ref_max
                if name in MICRO_TOL:
                    tol = MICRO_TOL[name] * ref_max
                    check(MICRO_TOL[name] or torch.equal(o, r), f"{name} [{label}]: not bitwise its plain")
                check(err <= tol, f"{name} [{label}] output {i}: max abs err {err:.3e} > {tol:.3e}")
                check(bool(torch.isfinite(o.float()).all()), f"{name} [{label}] non-finite output")
                if name in SPARSE_KERNELS and o.dtype != torch.float32:
                    rel = _rel_l2(o, r)
                    check(rel <= SPARSE_REL_L2,
                          f"{name} [{label}] output {i}: rel L2 err {rel:.3e} > {SPARSE_REL_L2:g}")
                    case_rel = rel if case_rel is None else max(case_rel, rel)
                if name in FLASH_FWD_ROWS and o.dtype != torch.float32:
                    row_rel = _row_rel_l2(torch, o, r)
                    check(row_rel <= FLASH_ROW_REL_L2, f"{name} [{label}]: a row's rel L2 err "
                          f"{row_rel:.3e} > {FLASH_ROW_REL_L2:g}")
                    extra_rec["row_rel_l2_err"] = row_rel
                if name in ROW_GATED_BWD:
                    row_rel = _bwd_row_rel_l2(torch, o, r)
                    tag = ("dk", "dv")[i] if name.startswith("flash_bwd_dkv") else "dq"
                    log(f"  {name} [{label}] {tag}: row rel L2 {row_rel:.3e} (gate {FLASH_BWD_ROW_REL_L2:g}; "
                        f"without the floor {_row_rel_l2(torch, o, r):.3e})")
                    check(row_rel <= FLASH_BWD_ROW_REL_L2, f"{name} [{label}] {tag}: a row's rel L2 err "
                          f"{row_rel:.3e} > {FLASH_BWD_ROW_REL_L2:g}")
                    extra_rec[f"{tag}_row_rel_l2_err"] = row_rel
                if name in BLOCK_KERNELS:
                    row_rel = _row_rel_l2(torch, o, r)
                    check(row_rel <= BLOCK_ROW_REL_L2, f"{name} [{label}]: a row's rel L2 err "
                          f"{row_rel:.3e} > {BLOCK_ROW_REL_L2:g}")
                    extra_rec["row_rel_l2_err"] = row_rel
                if name in DECODE_KERNELS:
                    case_rel, row_rel = _rel_l2(o, r), _row_rel_l2(torch, o, r)
                    check(row_rel <= DECODE_ROW_REL_L2, f"{name} [{label}]: a folded row's rel L2 err "
                          f"{row_rel:.3e} > {DECODE_ROW_REL_L2:g}")
                    check(case_rel <= DECODE_REL_L2,
                          f"{name} [{label}]: rel L2 err {case_rel:.3e} > {DECODE_REL_L2:g}")
                    extra_rec["row_rel_l2_err"] = row_rel
                case_err, case_ref = max(case_err, err), max(case_ref, ref_max)
            agg["max_abs_err"] = max(agg["max_abs_err"], case_err)
            if name in DECODE_KERNELS or name in SPARSE_KERNELS:  # memory a call takes beyond its inputs
                extra_rec["call_mib"] = _call_mib(torch, kern)
            k_ms, p_ms, l_ms = cuda_ms(kern, flush), cuda_ms(plain, flush, 3), cuda_ms(library, flush)
            b_ms, b_by = bound_ms(nbytes, flops)
            extra_ms = {key: cuda_ms(fn, flush) for key, fn in (extra[0] if extra else {}).items()}
            log(f"kernel {name} [{label}]: {k_ms:.4f} ms (plain {p_ms:.4f}, library "
                f"{'chain ' if library_kind == 'chain' else ''}{l_ms:.4f}, bound {b_ms:.4f} by "
                f"{b_by}{''.join(f', {key} {v:.4f}' for key, v in extra_ms.items())}), "
                f"max abs err {case_err:.3e} (max |plain| {case_ref:.3e})"
                + (f", rel L2 err {case_rel:.3e}" if case_rel is not None else "")
                + "".join(f", {key} {v:.4g}" for key, v in extra_rec.items()))
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
                                 "max_abs_plain": case_ref,
                                 **({} if case_rel is None else {"rel_l2_err": case_rel}), **extra_rec,
                                 **extra_ms})
        agg["bound_by"] = "bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms") else "operations"
        results[name] = agg
    del flush
    if "quant_matmul" in results:
        qmm_invariance(torch, dev)
        qmm_column_split(torch, dev)
    if any(name in BLOCK_KERNELS for name in results):
        block_invariance(torch, dev)
    if any(name in DECODE_KERNELS for name in results):
        decode_invariance(torch, dev)
        decode_planted_faults(torch, dev)
    if "flash_attention" in results:
        flash_planted_faults(torch, dev)
    if any(name in FLASH_BWD_KERNELS for name in results):
        flash_bwd_planted_faults(torch, dev)
    if any(name in MICRO_TOL for name in results):
        micro_planted_faults(torch, dev)
    return results


# ---------------------------------------------------------------------------
# phases 3-4: the main path


def counters():
    """{kernel: (wrapper, its launch-count attribute)}: every kernel's count,
    the int8-KV variants of the paged modes apart."""
    from deepspeed_tpu_torch.ops.decode_attention import (decode_attention,
                                                          extent_paged_decode_attention,
                                                          extent_paged_span_attention,
                                                          paged_decode_attention,
                                                          paged_span_attention)
    from deepspeed_tpu_torch.ops.decode_block import fused_out_mlp, fused_qkv_ln
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
    from deepspeed_tpu_torch.ops.qmm_microbench import qmm2, qmm3, qmm4
    from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        block_sparse_bwd_dkv, block_sparse_bwd_dq, block_sparse_fwd)
    fns = {"quant_matmul": quant_matmul, "flash_attention": flash_attention_fwd,
           "decode_attention": decode_attention, "fused_qkv_ln": fused_qkv_ln,
           "fused_out_mlp": fused_out_mlp, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
           "paged_decode_attention": paged_decode_attention, "paged_span_attention": paged_span_attention,
           "block_sparse_fwd": block_sparse_fwd, "block_sparse_bwd_dq": block_sparse_bwd_dq,
           "block_sparse_bwd_dkv": block_sparse_bwd_dkv, "qmm2": qmm2, "qmm3": qmm3, "qmm4": qmm4}
    out = {k: (fn, "launches") for k, fn in fns.items()}
    out["paged_decode_attention_int8"] = (paged_decode_attention, "launches_int8")
    out["paged_span_attention_int8"] = (paged_span_attention, "launches_int8")
    for name, fn in (("extent_paged_decode", extent_paged_decode_attention),
                     ("extent_paged_span", extent_paged_span_attention)):
        out[name] = (fn, "launches")
        out[name + "_int8"] = (fn, "launches_int8")
    return out


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


ZERO_COUNTS = {k: 0 for k in ("quant_matmul", "flash_attention", "decode_attention", "fused_qkv_ln",
                              "fused_out_mlp", "flash_bwd_dq", "flash_bwd_dkv",
                              "paged_decode_attention", "paged_span_attention",
                              "paged_decode_attention_int8", "paged_span_attention_int8",
                              "extent_paged_decode", "extent_paged_span", "extent_paged_decode_int8",
                              "extent_paged_span_int8", "block_sparse_fwd", "block_sparse_bwd_dq",
                              "block_sparse_bwd_dkv", "qmm2", "qmm3", "qmm4")}


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
    return {**ZERO_COUNTS, "quant_matmul": per_forward + steps * (1 if fused else per_forward),
            "flash_attention": L, "decode_attention": L * steps,
            "fused_qkv_ln": L * steps if fused else 0, "fused_out_mlp": L * steps if fused else 0}


# the remat policies under which the backward pass runs each block's flash
# forward again (the others keep its out and lse, or save everything)
RECOMPUTE_ATTN = ("nothing_saveable", "dots_saveable", "checkpoint_dots",
                  "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims")


def expected_train_counts(cfg, steps, gas=1, policy=None):
    """Launches of ``steps`` train steps of ``gas`` microbatches under the
    remat ``policy``: one flash forward (two under a policy of
    ``RECOMPUTE_ATTN``), one dq and one dk/dv per layer and microbatch,
    nothing else."""
    n = cfg.num_layers * gas * steps
    fwd = 2 * n if policy in RECOMPUTE_ATTN else n
    return {**ZERO_COUNTS, "flash_attention": fwd, "flash_bwd_dq": n, "flash_bwd_dkv": n}


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
    eng.generate(prompts, max_new_tokens=1)
    prefill = []
    for _ in range(3):  # the prefill and its one sampled token
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill.append(time.perf_counter() - t)
    log(f"{what} int8 decode, B={B}, prompt {P}: t(16)={times[16]:.4f} s, t(144)={times[144]:.4f} s, "
        f"steady step {step_s * 1e3:.3f} ms = {B / step_s:.1f} tok/s on {card}; prefill "
        f"(generate() of one new token, min of 3) {min(prefill) * 1e3:.3f} ms")
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


def gpt2_large_phase(torch, card, fused, params=None):
    """gpt2-large at full width and depth, int8, kernel injection. ``fused``:
    the default config (decode steps through the fused decode layer), the
    main path, then the serving phase on the same engine; else
    ``fused_decode_block: False`` (the per-projection path). ``params``: an
    int8 tree to serve (the fused engine's), else random weights from seed
    0 quantized on the host. Returns (launch
    counts of the greedy run, greedy rows, the serving phase's (mixed
    stream, int8 KV leg) launch counts and shared-prefix tokens or None, the
    engine's int8 weights for the gateway phase or None)."""
    import numpy as np
    import deepspeed_tpu_torch
    B, P, NEW = 8, 128, 128
    what = "gpt2-large " + ("fused" if fused else "per-projection")
    # the fused engine carries bench.py's serving section too: generate()
    # ignores it, and phase 5 serves through the same engine
    config = dict(SERVE_CONFIG) if fused else {"dtype": "int8", "kernel_inject": True,
                                               "max_out_tokens": 512, "fused_decode_block": False}
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference("gpt2-large", config=config, params=params)
    src = "the fused engine's int8 tree" if params is not None else "random weights, seed 0; host-side quantize"
    log(f"{what} int8 engine built in {time.perf_counter() - t0:.1f} s ({src})")
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
    serve_counts = serving_phase(torch, eng, card) if fused else None
    if not fused:
        per_projection_streams(torch, eng)
    params = eng.params if fused else None
    del eng
    torch.cuda.empty_cache()
    return counts, greedy, serve_counts, params


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


def llama_phase(torch, card=None):
    """llama3-8b at full width, 2 layers: generate(), the scheduler, the
    long-context phase and, given ``card``, the KV tier's extent-paging leg
    (``kv_extent_leg``) on the same engine."""
    import numpy as np
    import deepspeed_tpu_torch
    B, P, NEW = 4, 128, 32
    t0 = time.perf_counter()
    # the int8 tree made on the card (TP_MODEL at TP_LAYERS: llama3-8b, 2
    # layers), in the tp 1 engine's fused-qkv layout: a host-side init and
    # quantize of its 128256-row head took ~26 s
    model, tree = tp_int8_tree(torch, torch.device("cuda"))
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512,
                       "continuous_batching": {"enabled": True, "num_slots": 4}},
        params=fuse_qkv(torch, tree, model.cfg.num_layers))
    del tree
    log(f"llama3-8b (full width, depth cut to {model.cfg.num_layers} of 32 layers to keep set-up short) int8 "
        f"engine built in {time.perf_counter() - t0:.1f} s (seeded weights made on the card)")
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
    llama_serving_phase(torch, eng)
    long_counts = long_context_phase(torch, eng)
    if card is not None:
        timed_phase("kv tier: (c) extent paging", kv_extent_leg, torch, card, eng)
    del eng
    torch.cuda.empty_cache()
    return long_counts


# ---------------------------------------------------------------------------
# phase 5: continuous-batching serving (the scheduler's main path)


# bench.py::_serving_bench's settings (bench.py:219-255): int8 weights,
# kernel injection, 8 slots, 4 decode steps per host round trip
SERVE_CONFIG = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512,
                "continuous_batching": {"enabled": True, "num_slots": 8, "steps_per_sync": 4}}
SERVE_REQUESTS, SERVE_NEW = 32, 64
# the sequential generate() yardstick's requests, the mixed stream's first
# (a rate of one request at a time): all 32 took 34.3 s of a run that must
# stay inside its time limit
YARDSTICK_REQUESTS = 8


def mixed_stream(n=SERVE_REQUESTS, seed=SEED):
    """bench.py's open-loop mixed stream: prompt lengths in [8, 192), token
    ids in [0, 50257), all queued at t = 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 192, n)
    return [rng.integers(0, 50257, int(k)).astype(np.int32) for k in lens]


def shared_prefix_stream(sched, n=SERVE_REQUESTS, max_new=SERVE_NEW, seed=SEED):
    """bench.py's shared-system-prompt stream (bench.py:1790-1834): one
    common system prefix (128 tokens here) plus a 4-47-token suffix each."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    C = sched.prefill_chunk
    cap = sched.max_len - max_new - 2 * sched.steps_per_sync
    sys_len = min(max(C, min(2 * C, cap // 2)), cap - 5)
    system = rng.integers(0, 50257, sys_len).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, 50257, int(k)).astype(np.int32)])
            for k in rng.integers(4, min(48, cap - sys_len), n)], sys_len


def serve(sched, prompts, max_new=SERVE_NEW, collect=False):
    """Submit every prompt at t = 0 and pump the scheduler until all finish.
    Returns (streams, per-request logits or None, wall s, per-sync (shape,
    seconds), TTFT ms per request). Each step ends in the host's fetch of
    its token block, so its host-clock time is the sync's."""
    hs = [sched.submit(p, max_new_tokens=max_new, collect_logits=collect) for p in prompts]
    syncs = []
    t0 = time.perf_counter()
    while any(not h.done for h in hs):
        t = time.perf_counter()
        sched.step()
        syncs.append((sched.last_shape, time.perf_counter() - t))
    wall = time.perf_counter() - t0
    ttft = [(h._req.first_token_ts - h._req.submit_ts) * 1e3 for h in hs]
    logits = [h.result_logits() for h in hs] if collect else None
    return [h.result() for h in hs], logits, wall, syncs, ttft


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def check_serve_counts(sched, counts, what, int8_kv=False):
    """Launches over a served stream: per forward, kernel A and kernel C
    once per layer and the int8 head once; per layer the paged decode kernel
    once per width-1 forward and the span kernel once per chunk forward,
    in their bf16 or int8-KV variant; nothing else."""
    L = sched.engine.model_config.num_layers
    n1 = sched.forwards[1]
    nc = sum(v for c, v in sched.forwards.items() if c != 1)
    sfx = "_int8" if int8_kv else ""
    want = {**ZERO_COUNTS, "quant_matmul": n1 + nc, "fused_qkv_ln": L * (n1 + nc),
            "fused_out_mlp": L * (n1 + nc), "paged_decode_attention" + sfx: L * n1,
            "paged_span_attention" + sfx: L * nc}
    log(f"{what} launches {counts}, expected {want} ({n1} decode-width and {nc} chunk-width forwards "
        f"of {L} layers)")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    check(n1 > 0 and nc > 0, f"{what}: a width was never dispatched ({dict(sched.forwards)})")


def check_streams(outs, n, vocab, what, eos=None):
    for row in outs:
        ok_len = len(row) == n or (eos is not None and len(row) < n and row[-1] == eos)
        check(ok_len, f"{what}: a request returned {len(row)} tokens, expected {n}")
        check(bool(((row >= 0) & (row < vocab)).all()), f"{what}: token outside [0, {vocab})")


def step_logits_check(torch, eng, sched, what):
    """One chunk-width and one decode-width slot-pool step through the
    kernels against the same step through their plain versions on the card
    (``fused_paged_step``, two copies of the live pool): row 0 prefills 64
    columns over a retained prefix, rows 1-5 decode at their own positions,
    rows 6-7 are dead. Tolerance as the generate checks: relative L2 of the
    live columns' logits within 5e-2."""
    dev = eng.device
    model, ops = eng.module, eng._fast_tree()
    N, C = sched.cache.num_slots, sched.prefill_chunk
    worst = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for width in (C, 1):
        widx = torch.tensor([64, 70, 133, 200, 301, 90, 0, 0], device=dev)[:N]
        spans = torch.tensor([width, 1, 1, 1, 1, 1, 0, 0], device=dev)[:N]
        ids = torch.randint(0, eng.model_config.vocab_size, (N, width), generator=gen, device=dev)
        pos = widx[:, None] + torch.arange(width, device=dev)[None, :]
        out = {}
        with torch.inference_mode():
            for impl in ("kernel", "plain"):
                pool = tuple(tuple(t.clone() for t in comp) for comp in sched.cache.pool)
                out[impl] = model.fused_paged_step(ops, ids, pool, pos, widx, spans, impl=impl)[0].float()
                del pool
        lk = torch.cat([out["kernel"][b, :max(int(spans[b]), 1)] for b in range(N) if spans[b] > 0])
        lp = torch.cat([out["plain"][b, :max(int(spans[b]), 1)] for b in range(N) if spans[b] > 0])
        check(bool(torch.isfinite(lk).all()), f"{what}: non-finite step logits (width {width})")
        rel = float((lk - lp).norm() / lp.norm())
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        worst.append(rel)
        log(f"{what} slot-pool step of width {width}, kernels vs plain on the card: rel L2 {rel:.3e}, "
            f"argmax agreement {agree:.3f} over {lk.shape[0]} live columns")
    check(max(worst) <= 5e-2, f"{what}: step logits differ from plain by rel L2 {max(worst):.3e} > 5e-2")


def sync_profile(torch, sched, prompts, what):
    """Device time by kernel and the device's busy share over 3 chunk syncs
    (a fresh stream's admissions) and 3 decode syncs (after its prefills),
    each window under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    hs = [sched.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    out = {}
    for kind in ("chunk", "decode"):
        if kind == "decode":
            while sched._prefill is not None or sched.queue:
                sched.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            shapes = []
            for _ in range(3):
                sched.step()
                shapes.append(sched.last_shape)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        rows, busy_ms = device_profile(prof, 3)
        if not rows:
            log("profile: the profiler recorded no device time (device busy share not measured)")
            continue
        out[kind] = busy_ms / wall_ms
        log(f"profile of 3 {what} {kind} syncs {shapes}: per sync wall {wall_ms:.3f} ms under the "
            f"profiler, device busy {busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall")
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
            log(f"  device {ms:9.4f} ms/sync {n:5d} calls/sync  {key[:80]}")
    for h in hs:
        h.result()
    return out


def serving_phase(torch, eng, card):
    """gpt2-large (36 layers) served through the scheduler: the mixed
    stream timed with exact launch counts, twice and at K=1 (identical
    streams), the kernel-vs-plain step check, the shared-prefix stream (a
    radix hit bitwise equal to the same prompt cold; a retained slot's rows
    byte-stable while dead), sync profiles, the sequential generate()
    yardstick and the int8 KV leg. Returns the mixed stream's launch counts,
    the int8 leg's and the shared-prefix stream's tokens (the fleet phase's
    one-replica reference of that stream)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    vocab = eng.model_config.vocab_size
    sched = eng.scheduler()
    check(sched._fused_block, f"gpt2-large serving: fused gate closed ({sched._fused_block_reasons})")
    prompts = mixed_stream()
    # first-use costs (allocator, one chunk and one decode width) outside the timed stream
    serve(sched, prompts[:2], max_new=8)
    sched.forwards.clear()
    sched.dispatched.clear()
    sched.admitted = sched.evicted = sched.decode_steps = 0
    reset_counts()
    outs, _, wall, syncs, ttft = serve(sched, prompts)
    torch.cuda.synchronize()
    counts = read_counts()
    check_serve_counts(sched, counts, "gpt2-large serving (mixed stream)")
    check_streams(outs, SERVE_NEW, vocab, "gpt2-large serving")
    check(set(sched.dispatched) <= {(64, 4), (64, 1), (1, 4)},
          f"gpt2-large serving dispatched shapes {dict(sched.dispatched)}")
    n_tok = sum(len(o) for o in outs)
    chunk_s = [t for sh, t in syncs if sh[0] != 1]
    dec_s = [t for sh, t in syncs if sh[0] == 1]
    log(f"gpt2-large serving, mixed stream ({len(prompts)} requests, prompts 8-191, {SERVE_NEW} new, "
        f"8 slots, K=4, chunk 64): {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card}; "
        f"TTFT p50 {_pct(ttft, 50):.1f} ms, p95 {_pct(ttft, 95):.1f} ms; {len(chunk_s)} chunk syncs "
        f"(median {statistics.median(chunk_s) * 1e3:.3f} ms), {len(dec_s)} decode syncs (median "
        f"{statistics.median(dec_s) * 1e3:.3f} ms); shapes {dict(sched.dispatched)}; forwards "
        f"{dict(sched.forwards)}; admitted {sched.admitted}, evicted {sched.evicted}, decode steps "
        f"{sched.decode_steps}; pool {sched.cache.capacity_bytes() / 2**20:.1f} MiB, "
        f"{sched.cache.bytes_per_token()} B/token, token utilization "
        f"{sched.cache.token_utilization():.4f}")
    sched.radix.check_invariants()
    step_logits_check(torch, eng, sched, "gpt2-large serving")

    # determinism: the same stream on fresh schedulers, at K=4 and K=1
    eng._scheduler = sched = None
    torch.cuda.empty_cache()
    for k in (4, 1):
        again = DecodeScheduler(eng, num_slots=8, steps_per_sync=k)
        o2, _, w2, _, _ = serve(again, prompts)
        same = [bool(np.array_equal(a, b)) for a, b in zip(outs, o2)]
        log(f"gpt2-large serving, mixed stream again at K={k}: {w2:.3f} s, streams identical "
            f"{sum(same)}/{len(same)}")
        check(all(same), f"gpt2-large serving: greedy streams differ on a second run at K={k}")
        del again
        torch.cuda.empty_cache()

    # shared-prefix stream: radix hits and copy_slot
    sched = eng.scheduler()
    sp, sys_len = shared_prefix_stream(sched)
    outs_sp, _, wall_sp, _, ttft_sp = serve(sched, sp)
    check_streams(outs_sp, SERVE_NEW, vocab, "gpt2-large shared-prefix stream")
    n_sp = sum(len(o) for o in outs_sp)
    log(f"gpt2-large serving, shared-prefix stream ({len(sp)} requests: a {sys_len}-token system prefix "
        f"+ 4-47 tokens each): {n_sp} tokens in {wall_sp:.3f} s "
        f"= {n_sp / wall_sp:.1f} tokens/s; TTFT p50 {_pct(ttft_sp, 50):.1f} ms, p95 "
        f"{_pct(ttft_sp, 95):.1f} ms; radix hits {sched.radix.hits}, misses {sched.radix.misses}, "
        f"evictions {sched.radix.evictions}")
    check(sched.radix.hits > 0, "gpt2-large shared-prefix stream: no radix hit")
    sched.radix.check_invariants()
    # a hit's logits equal the same prompt's served cold, bit for bit
    probe = sp[5]
    hit = sched.submit(probe, max_new_tokens=8, collect_logits=True)
    hits_before = sched.radix.hits
    hit_logits = hit.result_logits()
    check(sched.radix.hits == hits_before + 1, "gpt2-large: the probe request was not a radix hit")
    # a retained slot stays byte-stable across syncs in which it is dead
    keep = max(sched.radix.registered_slots(), key=lambda sl: sched.radix._lru.get(sl, 0))
    snap = [t[keep].clone() for comp in sched.cache.pool for t in comp]
    serve(sched, [prompts[3]], max_new=8)
    check(sched.cache.state[keep] == "cached", "gpt2-large: the watched retained slot was reclaimed")
    leaves = [t for comp in sched.cache.pool for t in comp]
    stable = all(torch.equal(t[keep], x) for t, x in zip(leaves, snap))
    check(stable, "gpt2-large: a retained slot's pool rows changed while it was dead")
    del snap
    eng._scheduler = sched = None
    torch.cuda.empty_cache()
    cold_sched = DecodeScheduler(eng, num_slots=8, steps_per_sync=4, prefix_cache=False)
    cold_logits = cold_sched.submit(probe, max_new_tokens=8, collect_logits=True).result_logits()
    del cold_sched
    check(np.array_equal(hit_logits, cold_logits),
          f"gpt2-large: radix-hit logits differ from cold (max abs "
          f"{float(np.abs(hit_logits - cold_logits).max()):.3e})")
    log("gpt2-large serving: radix-hit logits bitwise equal to the cold prefill's (8 steps); a retained "
        "slot byte-stable across a stream it sat out")

    # where the time goes: sync profiles
    sched = eng.scheduler()
    sync_profile(torch, sched, prompts[:8], "gpt2-large serving")
    eng._scheduler = sched = None
    torch.cuda.empty_cache()

    # the yardstick: the same mixed stream's first YARDSTICK_REQUESTS through
    # sequential generate() calls
    eng.generate([prompts[0]], max_new_tokens=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_tok = sum(len(eng.generate([p], max_new_tokens=SERVE_NEW)[0]) for p in prompts[:YARDSTICK_REQUESTS])
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    log(f"gpt2-large sequential generate() yardstick, the same stream's first {YARDSTICK_REQUESTS} requests: "
        f"{seq_tok} tokens in {seq_s:.3f} s "
        f"= {seq_tok / seq_s:.1f} tokens/s; the scheduler served {n_tok / wall / (seq_tok / seq_s):.2f}x it")

    int8_counts = int8_kv_leg(torch, eng, prompts[:8])
    speculative_leg(torch, eng, card)
    monolithic_leg(torch, eng, card, prompts, outs)
    return counts, int8_counts, outs_sp


def speculative_stream(vocab, cap, n=SERVE_REQUESTS, seed=SEED):
    """bench.py::_speculative_bench's stream: one 7-token pattern resized to
    the prompt (96 tokens, or the slot's room), plus 2 random tokens each."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    pattern = rng.integers(0, vocab, 7).astype(np.int32)
    plen = min(96, cap)
    return [np.concatenate([np.resize(pattern, plen - 2), rng.integers(0, vocab, 2).astype(np.int32)])
            for _ in range(n)]


SPEC_TOKENS = 4


def speculative_leg(torch, eng, card):
    """Self-speculative decoding on gpt2-large (int8, fused, 8 slots, K=4):
    bench.py's speculative stream at spec_tokens=4 and 0 on fresh
    schedulers, each warmed by one request: greedy streams and one sampled
    request bitwise equal, on the bf16 pool and on an int8 KV pool (the
    first 8 requests); exact launch counts of the verify forwards (the span
    kernel at W = 5 columns, kernels A and C and the int8 head at M = 8 x 5
    rows); drafts accepted and more than one token per (row, verify sync);
    tokens/s of both legs; the device's busy share of one verify sync."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    vocab = eng.model_config.vocab_size
    W = 1 + SPEC_TOKENS
    sampled_kw = dict(max_new_tokens=SERVE_NEW, do_sample=True, temperature=0.8, top_k=50, top_p=0.95,
                      seed=5)
    res = {}
    for kv in ("auto", "int8"):
        for spec in (0, SPEC_TOKENS):
            sched = DecodeScheduler(eng, num_slots=8, steps_per_sync=4, spec_tokens=spec,
                                    kv_cache_dtype=kv)
            if kv == "auto" and spec == 0:
                cap = sched.max_len - SERVE_NEW - 2 * sched.steps_per_sync - SPEC_TOKENS - 1
                prompts = speculative_stream(vocab, cap)
            stream = prompts if kv == "auto" else prompts[:8]
            sched.submit(stream[0], max_new_tokens=8).result()  # first-use costs
            torch.cuda.synchronize()
            sched.forwards.clear()
            sched.dispatched.clear()
            sched.spec_steps = sched.spec_row_steps = sched.spec_drafted = 0
            sched.spec_accepted = sched.spec_delivered = 0
            reset_counts()
            outs, _, wall, syncs, ttft = serve(sched, stream, max_new=SERVE_NEW)
            torch.cuda.synchronize()
            counts = read_counts()
            check_streams(outs, SERVE_NEW, vocab, f"gpt2-large speculative leg (spec {spec}, {kv} KV)")
            check_serve_counts(sched, counts, f"gpt2-large speculative leg (spec {spec}, {kv} KV)",
                               int8_kv=kv == "int8")
            sampled = sched.submit(stream[1], **sampled_kw).result()
            n_tok = sum(len(o) for o in outs)
            res[kv, spec] = (outs, sampled, n_tok / wall, sched)
            log(f"gpt2-large speculative leg, spec_tokens={spec}, {kv} KV, {len(stream)} requests of "
                f"{len(stream[0])} tokens, {SERVE_NEW} new: {n_tok} tokens in {wall:.3f} s = "
                f"{n_tok / wall:.1f} tokens/s on {card}; TTFT p50 {_pct(ttft, 50):.1f} ms; shapes "
                f"{dict(sched.dispatched)}; spec steps {sched.spec_steps}, drafted {sched.spec_drafted}, "
                f"accepted {sched.spec_accepted}, tokens per (row, verify) "
                f"{sched.mean_spec_tokens_per_step():.3f}")
            if spec:
                check(sched.dispatched[("spec", W)] == sched.spec_steps > 0,
                      f"speculative leg ({kv} KV): no verify sync ran ({dict(sched.dispatched)})")
                check(sched.spec_accepted > 0 and sched.mean_spec_tokens_per_step() > 1.0,
                      f"speculative leg ({kv} KV): accepted {sched.spec_accepted}, tokens per step "
                      f"{sched.mean_spec_tokens_per_step():.3f}")
                sched.cache.check_invariants()
            if kv == "auto" and spec:
                # where a verify sync's time goes
                hs = [sched.submit(p, max_new_tokens=SERVE_NEW) for p in prompts[8:16]]
                while sched.queue or sched._prefill is not None:
                    sched.step()
                for _ in range(6):
                    if one_sync_profile(torch, sched, "gpt2-large speculative sync")[0] == "spec":
                        break
                for h in hs:
                    h.result()
            del sched
            torch.cuda.empty_cache()
        (o0, s0, r0, _), (o1, s1, r1, _) = res[kv, 0], res[kv, SPEC_TOKENS]
        same = [bool(np.array_equal(a, b)) for a, b in zip(o0, o1)]
        log(f"gpt2-large speculative leg, {kv} KV: greedy streams identical {sum(same)}/{len(same)}, "
            f"sampled stream identical {bool(np.array_equal(s0, s1))}; spec/non-spec tokens/s "
            f"{r1 / r0:.3f}")
        check(all(same), f"speculative leg ({kv} KV): greedy streams differ from spec_tokens=0")
        check(np.array_equal(s0, s1), f"speculative leg ({kv} KV): the sampled stream differs")


def monolithic_logits_check(torch, eng, prompts, what):
    """Per prefill bucket, the first-token logits of the monolithic prefill
    (one slot, the prompt right-padded to its bucket) through the kernels
    against their plain versions on the card, within the gate of
    ``prefill_logits_check`` (relative L2 5e-2)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import _bucket_len
    worst = {}
    for p in prompts:
        L = len(p)
        Pb = _bucket_len(L, 64, 512)
        if Pb in worst:
            continue
        ids = np.zeros((1, Pb), np.int64)
        ids[0, :L] = p
        ids = torch.as_tensor(ids, device=eng.device)
        out = {}
        with torch.inference_mode():
            for impl in ("kernel", "plain"):
                cache = eng.module.init_cache(1, 512, device=eng.device)
                out[impl] = eng.module.apply_with_cache(eng.net, ids, cache, 0, impl=impl)[0][0, L - 1].float()
        check(bool(torch.isfinite(out["kernel"]).all()), f"{what}: non-finite prefill logits (bucket {Pb})")
        worst[Pb] = float((out["kernel"] - out["plain"]).norm() / out["plain"].norm())
    log(f"{what} first-token logits, kernels vs plain on the card, rel L2 by bucket {worst}")
    check(max(worst.values()) <= 5e-2, f"{what}: first-token logits differ from plain beyond 5e-2")


def monolithic_leg(torch, eng, card, prompts, chunked_outs):
    """The monolithic prefill (``prefill_chunk=0, prefix_cache=False``,
    bench.py's per-concurrency leg) on gpt2-large (int8, fused decode, 8
    slots, K=4): the mixed 32-request stream with exact launch counts (per
    prefill every projection and the head at the bucket's width and, from
    the 128 bucket up, the flash forward once a layer; then the fused decode
    syncs), tokens/s, TTFT p50/p95, and how many streams part from the
    chunked run's (the chunked path attends a prompt through the span
    kernel, the monolithic one through flash at the padded width, so bf16
    streams may part where two logits are close); each bucket's first-token
    logits against the plain versions."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    what = "gpt2-large monolithic prefill"
    monolithic_logits_check(torch, eng, prompts, what)
    sched = DecodeScheduler(eng, num_slots=8, steps_per_sync=4, prefill_chunk=0, prefix_cache=False)
    check(sched.radix is None, f"{what}: radix cache on")
    serve(sched, prompts[:2], max_new=8)  # first-use costs
    sched.dispatched.clear()
    sched.forwards.clear()
    reset_counts()
    outs, _, wall, syncs, ttft = serve(sched, prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    cfg = eng.model_config
    L = cfg.num_layers
    buckets = {k[1]: n for k, n in sched.dispatched.items() if k[0] == "prefill"}
    n_pf = sum(buckets.values())
    n1 = sched.forwards[1]
    want = {**ZERO_COUNTS, "quant_matmul": (4 * L + 1) * n_pf + n1,
            "flash_attention": L * sum(n for b, n in buckets.items() if b >= 128),
            "fused_qkv_ln": L * n1, "fused_out_mlp": L * n1, "paged_decode_attention": L * n1}
    log(f"{what} launches {counts}, expected {want} (prefills by bucket {buckets}, {n1} decode forwards)")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    check(n_pf == len(prompts) and set(sched.forwards) == {1}, f"{what}: dispatches {dict(sched.dispatched)}")
    check_streams(outs, SERVE_NEW, eng.model_config.vocab_size, what)
    n_tok = sum(len(o) for o in outs)
    parted = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
              for x, y in zip(outs, chunked_outs)]
    log(f"{what}, mixed stream ({len(prompts)} requests, 8 slots, K=4, buckets from 64): {n_tok} tokens "
        f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s on {card}; TTFT p50 {_pct(ttft, 50):.1f} ms, "
        f"p95 {_pct(ttft, 95):.1f} ms; streams parting from the chunked run's "
        f"{sum(p is not None for p in parted)}/{len(parted)} (at tokens "
        f"{[p for p in parted if p is not None]})")
    sched.cache.check_invariants()
    del sched
    torch.cuda.empty_cache()


def per_projection_streams(torch, eng):
    """The mixed stream through the per-projection scheduler (an engine with
    ``fused_decode_block: False``: every projection through quant_matmul, at
    M = 8 slots in decode forwards and 8 x 64 in chunk forwards) at K=4 and
    at K=1: identical streams. A row's token rides forwards of other widths
    at the two K, so this holds only while quant_matmul's rows do not
    depend on M (the same segment partials and fma chain at every M)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    prompts = mixed_stream()
    outs = {}
    for k in (4, 1):
        sched = DecodeScheduler(eng, num_slots=8, steps_per_sync=k)
        check(not sched._fused_block, "per-projection serving: the fused gate is open")
        outs[k], _, wall, _, _ = serve(sched, prompts)
        log(f"gpt2-large per-projection serving, mixed stream at K={k}: {wall:.3f} s, shapes "
            f"{dict(sched.dispatched)}")
        del sched
        torch.cuda.empty_cache()
    same = [bool(np.array_equal(a, b)) for a, b in zip(outs[4], outs[1])]
    prefix = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
              for x, y in zip(outs[4], outs[1])]
    log(f"gpt2-large per-projection serving, mixed stream K=4 vs K=1: streams identical "
        f"{sum(same)}/{len(same)}; common prefix of the others {[p for p, m in zip(prefix, same) if not m]}")
    check(all(same), "per-projection serving: greedy streams differ between K=4 and K=1")


def int8_kv_leg(torch, eng, prompts):
    """The mixed stream's first 8 requests on an int8 KV pool against the
    bf16 pool, logits collected: >= 1.9x the rows per byte, the launches of
    the int8 variants, and per-step logits within 0.05 * max|ref| + 0.05
    (the JAX test's bound) on every step whose inputs agree (up to and
    including a row's first greedy flip; after it the streams feed other
    tokens)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    ref_s = DecodeScheduler(eng, num_slots=8, steps_per_sync=4)
    _, ref, _, _, _ = serve(ref_s, prompts, collect=True)
    bpt_ref = ref_s.cache.bytes_per_token()
    del ref_s
    torch.cuda.empty_cache()
    q_s = DecodeScheduler(eng, num_slots=8, steps_per_sync=4, kv_cache_dtype="int8")
    reset_counts()
    _, got, wall, _, _ = serve(q_s, prompts, collect=True)
    torch.cuda.synchronize()
    counts = read_counts()
    check_serve_counts(q_s, counts, "gpt2-large int8 KV leg", int8_kv=True)
    ratio = bpt_ref / q_s.cache.bytes_per_token()
    errs, flips = [], 0
    for r, g in zip(ref, got):
        same = r.argmax(-1) == g.argmax(-1)
        n = len(same) if same.all() else int(np.argmin(same)) + 1
        flips += int(not same.all())
        errs.append((float(np.abs(g[:n] - r[:n]).max()), float(np.abs(r[:n]).max())))
    worst = max(e / (0.05 * m + 0.05) for e, m in errs)
    log(f"gpt2-large int8 KV leg ({len(prompts)} requests): {q_s.cache.bytes_per_token()} vs {bpt_ref} "
        f"B/token = {ratio:.3f}x rows per byte; logit error / bound worst {worst:.3f} (max abs "
        f"{max(e for e, _ in errs):.3e}, max |ref| {max(m for _, m in errs):.3e}); rows whose greedy "
        f"choice flipped {flips}/{len(prompts)}; {wall:.3f} s")
    check(ratio >= 1.9, f"int8 KV pool only {ratio:.3f}x denser than bf16")
    check(worst <= 1.0, "int8 KV logit error beyond 0.05 * max|ref| + 0.05")
    q_s.radix.check_invariants()
    del q_s
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5c: the serving gateway over HTTP, with telemetry


GATEWAY_KV_REQUESTS = 8
GATEWAY_SAMPLE_EVERY = 8
_PROM_LINE = r"^(# (TYPE|HELP) .*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? ([0-9eE.+-]+|NaN|[+-]Inf)( [0-9]+)?)$"


def fp16_edge_rows(torch, dev, seed=5):
    """K/V rows (1, 4, T, 16) whose max |x| puts max / 127 at an fp16
    rounding edge where the exact quotient and the product with
    fp32(1/127) round to different fp16 scales (the 127 multiples of fp16
    midpoints and their fp32 neighbours), then random rows. Returns (k, v,
    edge rows)."""
    h = torch.arange(0x1400, 0x4400, dtype=torch.int32).to(torch.int16).view(torch.float16).float()
    mid = ((h[:-1].double() + h[1:].double()) / 2 * 127).float()
    cands = torch.cat([torch.nextafter(mid, mid + s) for s in (-1, 1)] + [mid])
    quot = (cands / torch.full_like(cands, 127.0)).half()
    recip = (cands * torch.tensor(1 / 127, dtype=torch.float32)).half()
    edges = cands[quot != recip]
    n = edges.numel()
    g = torch.Generator().manual_seed(seed)
    k = torch.rand((1, 4, n + 16, 16), generator=g) * 2 - 1
    v = torch.rand((1, 4, n + 16, 16), generator=g) * 2 - 1
    k[0, :, :n] *= edges[None, :, None] / 2
    v[0, :, :n] *= edges[None, :, None] / 2
    k[0, 1, :n, 3] = -edges
    return k.to(dev), v.to(dev), n


def kv_quant_check(torch, dev):
    """``quantize_kv_rows`` (the int8 KV pool's row quantizer) on the card
    bitwise its CPU run, int8 rows and fp16 scales, on rows at fp16
    rounding edges and random rows."""
    from deepspeed_tpu_torch.ops.quantizer import quantize_kv_rows
    k, v, n = fp16_edge_rows(torch, dev)
    kq, vq, sc = quantize_kv_rows(k, v)
    ck, cv, cs = quantize_kv_rows(k.cpu(), v.cpu())
    same = (torch.equal(sc.cpu().view(torch.int16), cs.view(torch.int16))
            and torch.equal(kq.cpu(), ck) and torch.equal(vq.cpu(), cv))
    # the repaired fault: the same scales with the divisor a Python 127.0
    amax = torch.maximum(k.float().abs().amax(dim=(1, 3)), v.float().abs().amax(dim=(1, 3)))
    old = torch.clamp(amax / 127.0, min=1e-8).half()
    moved = int((old.cpu().view(torch.int16) != sc.reshape(old.shape).cpu().view(torch.int16)).sum())
    log(f"quantize_kv_rows on the card vs the CPU: {n} rows at fp16 scale edges + 16 random, "
        f"int8 rows and fp16 scales bitwise equal: {same}; a Python 127.0 divisor would give "
        f"{moved} of these {n + 16} rows another fp16 scale on this device")
    check(same, "quantize_kv_rows differs between the card and the CPU")


def _http(port, method, path, body=None, headers=None, timeout=600):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def http_stream(port, prompts, max_new):
    """Every prompt as a concurrent streaming POST from its own client
    thread, all sent at once. Returns (per-request (status, token ids,
    client TTFB ms, finish reason), wall s from the first send to the
    last [DONE])."""
    import http.client
    import threading
    out = [None] * len(prompts)
    go = threading.Event()

    def client(i):
        go.wait()
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        toks, ttfb, reason = [], None, None
        try:
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [int(t) for t in prompts[i]], "max_tokens": max_new,
                                     "stream": True}), {"x-tenant-id": f"client{i % 4}"})
            resp = conn.getresponse()
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                if ttfb is None:
                    ttfb = (time.perf_counter() - t0) * 1e3
                choice = json.loads(line[6:])["choices"][0]
                toks += choice["token_ids"]
                reason = choice["finish_reason"] or reason
            out[i] = (resp.status, toks, ttfb, reason)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i, ), daemon=True) for i in range(len(prompts))]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(600)
        check(not t.is_alive(), "gateway: a client thread did not finish within 600 s")
    return out, time.perf_counter() - t0


def device_busy_share(path):
    """(busy ms, window ms) of a torch.profiler Chrome trace: the union of
    its device kernel intervals over the span of all its events; None
    without device events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e and e.get("ph") == "X"]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    return busy / 1e3, (hi - lo) / 1e3


def gap_breakdown(snap):
    """The host-gap buckets, the sync launch and wait times, in ms per
    sync, from a telemetry snapshot, and the gap total against the buckets'
    sum."""
    hist = snap["histograms"]
    n = max(1, hist["serving/host_gap_ms"]["count"])
    buckets = {k.split("/")[-1][:-3]: v["total"] / n for k, v in snap["counters"].items()
               if k.startswith("serving/host_gap/")}
    per_sync = {name: hist[f"serving/sync_{name}_ms"]["sum"] / max(1, hist[f"serving/sync_{name}_ms"]["count"])
                for name in ("launch", "wait")}
    return buckets, per_sync, hist["serving/host_gap_ms"]["sum"] / n, n


def gateway_phase(torch, card, params, model="gpt2-large"):
    """gpt2-large int8 (serving_phase's configuration: kernel-injected,
    fused, 8 slots x 512, K = 4, chunk 64) behind the HTTP gateway on the
    card, with telemetry on (a capacity sample every 8th sync), on the
    fused engine's weights (``params=``: no second random init). The mixed
    stream's 32 requests go as concurrent streaming POSTs; each stream must
    equal bitwise the same request's tokens from a direct
    ``scheduler().submit()`` on the engine, with exact launch counts. Then,
    through HTTP: /v1/metrics as JSON and Prometheus text (requests
    counted, ``serving/mfu`` and ``serving/hbm_bw_util`` in (0, 1.05], the
    host-gap buckets summing to ``serving/host_gap_ms`` within 1%), a drain
    and a 503 after it. The int8-KV leg serves the first 8 requests the
    same way on an int8 pool (bitwise its direct run, the int8 variants'
    exact counts) under a ``POST /v1/debug/profile`` capture (the device's
    busy share). ``tools/trace_summary.py`` must read the JSONL. Logs HTTP
    against in-process tokens/s, TTFB p50/p95, queue-wait p95, the busy
    share and the host-gap buckets in ms per sync. Returns the bf16 and the
    int8-KV streams' launch counts, and the bf16 stream's (HTTP tokens/s,
    direct streams) for the fleet phase."""
    import re
    import shutil
    import tempfile
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    from deepspeed_tpu_torch.serving import Gateway
    from deepspeed_tpu_torch.telemetry import set_sink
    kv_quant_check(torch, torch.device("cuda"))
    tel_dir = tempfile.mkdtemp(prefix="gateway_telemetry_")
    config = {**SERVE_CONFIG,
              "telemetry": {"enabled": True, "output_path": tel_dir, "flush_interval": 1000,
                            "capacity_sample_every": GATEWAY_SAMPLE_EVERY},
              "gateway": {"port": 0, "max_queue_depth": 64, "request_timeout_s": 600.0,
                          "drain_timeout_s": 120.0}}
    set_sink(None)
    eng = deepspeed_tpu_torch.init_inference(model, config=config, params=params)
    check(eng.telemetry.enabled, "gateway phase: the telemetry sink is off")
    vocab = eng.model_config.vocab_size
    prompts = [p % vocab for p in mixed_stream()]
    warm = np.random.default_rng(SEED + 99).integers(0, vocab, 40).astype(np.int32)

    # the reference: the same stream by direct submit on the engine's scheduler
    sched = eng.scheduler()
    check(sched._fused_block, f"gateway phase: fused gate closed ({sched._fused_block_reasons})")
    serve(sched, [warm], max_new=8)
    direct, _, wall_direct, _, _ = serve(sched, prompts)
    n_direct = sum(len(o) for o in direct)
    eng._scheduler = sched = None
    torch.cuda.empty_cache()

    gw = Gateway(eng).start_background(timeout=300)
    sched = gw.scheduler
    try:
        status, _, _ = _http(gw.port, "POST", "/v1/completions",
                             {"prompt": warm.tolist(), "max_tokens": 8})
        check(status == 200, f"gateway warm-up request answered {status}")
        torch.cuda.synchronize()
        sched.forwards.clear()
        reset_counts()
        res, wall = http_stream(gw.port, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        counts = read_counts()
        check_serve_counts(sched, counts, "gateway stream (bf16 KV)")
        for i, (status, toks, _, reason) in enumerate(res):
            check(status == 200 and reason == "length", f"gateway request {i}: {status} {reason}")
            check(toks == direct[i].tolist(),
                  f"gateway request {i}: the SSE stream differs from direct submit")
        n_http = sum(len(r[1]) for r in res)
        ttfb = [r[2] for r in res]
        snap = eng.telemetry.snapshot()
        qw = snap["histograms"]["gateway/queue_wait_ms"]
        log(f"gateway (HTTP/1.1 + SSE, {len(prompts)} concurrent streaming POSTs, the mixed stream, "
            f"{SERVE_NEW} new each, 8 slots, K=4, chunk 64): {n_http} tokens in {wall:.3f} s = "
            f"{n_http / wall:.1f} tokens/s; in-process direct submit of the same stream "
            f"{n_direct / wall_direct:.1f} tokens/s ({wall_direct:.3f} s); HTTP/in-process "
            f"{(n_http / wall) / (n_direct / wall_direct):.3f}; client TTFB p50 {_pct(ttfb, 50):.1f} ms, "
            f"p95 {_pct(ttfb, 95):.1f} ms; queue wait p95 {qw['p95']:.1f} ms (p50 {qw['p50']:.1f}); "
            f"streams bitwise equal to direct submit {len(res)}/{len(res)} on {card}")

        # the metrics surface
        status, _, body = _http(gw.port, "GET", "/v1/metrics")
        metrics = json.loads(body)
        sent = 1 + len(prompts)
        tel_req = metrics["telemetry"]["counters"]["gateway/requests"]["total"]
        check(status == 200 and metrics["gateway"]["requests"] == sent == tel_req,
              f"gateway/requests {metrics['gateway']['requests']} (sink {tel_req}) != {sent} sent")
        status, headers, body = _http(gw.port, "GET", "/v1/metrics", headers={"Accept": "text/plain"})
        text = body.decode()
        bad = [line for line in text.strip().splitlines() if not re.match(_PROM_LINE, line)]
        check(status == 200 and headers["Content-Type"].startswith("text/plain") and not bad,
              f"Prometheus text: {status}, unparseable lines {bad[:3]}")
        check(f"dstpu_gateway_requests_total {sent}" in text, "Prometheus text lacks the request count")
        g = metrics["telemetry"]["gauges"]
        mfu, bw = g.get("serving/mfu", 0.0), g.get("serving/hbm_bw_util", 0.0)
        check(0.0 < mfu <= 1.05 and 0.0 < bw <= 1.05, f"serving/mfu {mfu}, serving/hbm_bw_util {bw}")
        buckets, per_sync, gap_ms, n_gaps = gap_breakdown(metrics["telemetry"])
        total = sum(buckets.values())
        check(abs(total - gap_ms) <= 0.01 * gap_ms,
              f"host-gap buckets sum {total:.6f} ms != serving/host_gap_ms {gap_ms:.6f} ms")
        step_ms = metrics["telemetry"]["histograms"]["serving/step_ms"]
        log(f"gateway capacity (a fenced sync every {GATEWAY_SAMPLE_EVERY}th; last sample): serving/mfu "
            f"{mfu:.5f}, serving/hbm_bw_util {bw:.5f}, roofline "
            f"{ {k.split('/')[-1]: round(v, 4) for k, v in g.items() if k.startswith('serving/roofline/')} }; "
            f"programs {metrics['capacity']['programs']}")
        log(f"gateway host gap per sync over {n_gaps} syncs: {gap_ms:.4f} ms = "
            + " + ".join(f"{k} {v:.4f}" for k, v in buckets.items())
            + f" (sum {total:.4f}); a sync's launch (host enqueue of its forwards) "
            f"{per_sync['launch']:.4f} ms, its wait on the device {per_sync['wait']:.4f} ms; "
            f"serving/step_ms p50 {step_ms['p50']:.3f}")

        # drain with a request in flight: it finishes in full, the door closes
        import threading
        held = []
        t = threading.Thread(target=lambda: held.append(http_stream(gw.port, [warm], 128)[0][0]))
        t.start()
        deadline = time.monotonic() + 120
        while not gw._active and time.monotonic() < deadline:
            time.sleep(0.005)
        check(bool(gw._active), "gateway: the drain's in-flight request was never admitted")
        gw.begin_drain()
        status, headers, _ = _http(gw.port, "POST", "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2})
        check(status == 503 and int(headers.get("Retry-After", 0)) >= 1,
              f"gateway: {status} after the drain began, expected 503 with a Retry-After")
        t.join(600)
        check(not t.is_alive() and held and held[0][0] == 200 and len(held[0][1]) == 128,
              "gateway: the request in flight at the drain did not finish in full")
        check(gw.wait_drained(120), "gateway: the drain did not complete")
    finally:
        gw.close(timeout=120)
    eng._scheduler = sched = None
    torch.cuda.empty_cache()

    # the int8 KV leg: the first 8 requests on an int8 pool, profiled
    kv_prompts = prompts[:GATEWAY_KV_REQUESTS]
    ref = DecodeScheduler(eng, num_slots=8, steps_per_sync=4, kv_cache_dtype="int8")
    serve(ref, [warm], max_new=8)
    direct_q, _, _, _, _ = serve(ref, kv_prompts)
    del ref
    torch.cuda.empty_cache()
    eng.scheduler(kv_cache_dtype="int8")
    gw = Gateway(eng).start_background(timeout=300)
    sched = gw.scheduler
    try:
        _http(gw.port, "POST", "/v1/completions", {"prompt": warm.tolist(), "max_tokens": 8})
        torch.cuda.synchronize()
        sched.forwards.clear()
        reset_counts()
        status, _, body = _http(gw.port, "POST", "/v1/debug/profile", {"duration_ms": 1500})
        check(status == 200, f"POST /v1/debug/profile answered {status}")
        trace_dir = json.loads(body)["path"]
        status, _, _ = _http(gw.port, "POST", "/v1/debug/profile", {"duration_ms": 100})
        check(status == 409, f"a second POST /v1/debug/profile answered {status}, expected 409")
        res_q, wall_q = http_stream(gw.port, kv_prompts, SERVE_NEW)
        torch.cuda.synchronize()
        counts_q = read_counts()
        check_serve_counts(sched, counts_q, "gateway stream (int8 KV)", int8_kv=True)
        for i, (status, toks, _, _) in enumerate(res_q):
            check(status == 200 and toks == direct_q[i].tolist(),
                  f"gateway int8-KV request {i}: the SSE stream differs from direct submit")
    finally:
        check(gw.close(timeout=120), "gateway (int8 KV) did not drain")
    capture = os.path.join(trace_dir, "capture.trace.json")
    check(os.path.exists(capture), f"gateway int8-KV leg: no profiler capture at {capture}")
    busy = device_busy_share(capture)
    check(busy is not None, "gateway int8-KV leg: the profiler capture holds no device kernel")
    n_q = sum(len(r[1]) for r in res_q)
    log(f"gateway int8-KV leg ({len(kv_prompts)} streaming POSTs): {n_q} tokens in {wall_q:.3f} s = "
        f"{n_q / wall_q:.1f} tokens/s, streams bitwise equal to direct submit {len(res_q)}/{len(res_q)}; "
        f"device busy {busy[0]:.3f} ms of a {busy[1]:.3f} ms torch.profiler capture "
        f"(POST /v1/debug/profile, 1.5 s) = {busy[0] / busy[1]:.4f}")
    eng.telemetry.flush()
    summary = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                              eng.telemetry.jsonl_path], capture_output=True, text=True, timeout=120)
    check(summary.returncode == 0, f"tools/trace_summary.py failed: {summary.stderr[-500:]}")
    for line in summary.stdout.splitlines():
        if "host_gap" in line or "ttfb" in line or "sync_" in line:
            log(f"  trace_summary: {line.strip()}")
    eng.telemetry.close()
    set_sink(None)
    shutil.rmtree(tel_dir)
    del eng
    torch.cuda.empty_cache()
    return counts, counts_q, (n_http / wall, direct)


# ---------------------------------------------------------------------------
# phase 5d: the serving fleet (two replicas on the card, phase roles, the
# gateway across two ranks)


FLEET_MODEL = "gpt2-large"  # "tiny-gpt2" rehearses (a)-(d) on the CPU
FLEET_REPLICAS = 2
FLEET_FAIL_AFTER = 3        # replica 1's steps before the planted failure
FLEET_TP_SLOTS, FLEET_TP_NEW = 4, 32
FLEET_TP_DISCONNECT_NEW = 200
FLEET_TIMEOUT_S = 300


def _hist(snap, name):
    h = snap["histograms"].get(name)
    return (h["sum"], h["count"]) if h else (0.0, 0)


def fleet_gateway(eng, replicas):
    """The engine's gateway over ``replicas`` replicas (the engine's config
    says how many), started; the engine's scheduler singleton is made anew."""
    from deepspeed_tpu_torch.serving import Gateway
    eng._scheduler = None
    eng._config.continuous_batching.replicas = replicas
    return Gateway(eng).start_background(timeout=300)


def fleet_http_leg(torch, card, eng, prompts, direct, warm, replicas):
    """The mixed stream as concurrent streaming POSTs through a gateway of
    ``replicas``: every stream bitwise its direct one-replica submit,
    launch counts exact as the sum over the replicas' forwards, each
    replica placed, its sync launch and wait in ms. Returns (tokens/s,
    launch counts, the gateway, still open)."""
    import types
    gw = fleet_gateway(eng, replicas)
    try:
        warmers = [warm] * replicas  # least-loaded spreads them: every replica warm
        res, _ = http_stream(gw.port, warmers, 8)
        check(all(r[0] == 200 for r in res), f"fleet x{replicas}: a warm-up request failed")
        torch.cuda.synchronize()
        for rep in gw.replicas:
            rep.scheduler.forwards.clear()
        before = eng.telemetry.snapshot()
        dispatched0 = [rep.dispatched for rep in gw.replicas]
        reset_counts()
        res, wall = http_stream(gw.port, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        counts = read_counts()
        total = sum((rep.scheduler.forwards for rep in gw.replicas), start=type(gw.scheduler.forwards)())
        check_serve_counts(types.SimpleNamespace(engine=eng, forwards=total), counts,
                           f"fleet x{replicas} stream (sum over replicas)")
        for i, (status, toks, _, reason) in enumerate(res):
            check(status == 200 and reason == "length", f"fleet x{replicas} request {i}: {status} {reason}")
            check(toks == direct[i].tolist(), f"fleet x{replicas} request {i}: the SSE stream differs from "
                                              f"the direct one-replica submit")
        placed = [rep.dispatched - d for rep, d in zip(gw.replicas, dispatched0)]
        check(sum(placed) == len(prompts) and all(placed), f"fleet x{replicas}: placements {placed}")
        after = eng.telemetry.snapshot()
        per_rep = []
        for rep in gw.replicas:
            ms = []
            for kind in ("launch", "wait"):
                name = f"serving/replica/{rep.idx}/sync_{kind}_ms"
                (s1, n1), (s0, n0) = _hist(after, name), _hist(before, name)
                ms.append((s1 - s0) / max(1, n1 - n0))
            per_rep.append(f"replica {rep.idx}: {placed[rep.idx]} placed, {n1 - n0} syncs, launch "
                           f"{ms[0]:.4f} ms, wait {ms[1]:.4f} ms a sync")
        n_tok = sum(len(r[1]) for r in res)
        ttfb = [r[2] for r in res]
        log(f"fleet x{replicas} (HTTP/1.1 + SSE, {len(prompts)} concurrent streaming POSTs, the mixed stream, "
            f"{SERVE_NEW} new each, 8 slots a replica, K=4, chunk 64): {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} tokens/s; TTFB p50 {_pct(ttfb, 50):.1f} ms, p95 {_pct(ttfb, 95):.1f} ms; "
            f"streams bitwise the direct one-replica submit {len(res)}/{len(res)}; " + "; ".join(per_rep)
            + f" on {card}")
        return n_tok / wall, counts, gw
    except BaseException:
        gw.close(timeout=120)
        raise


def fleet_shared_leg(gw, prompts, direct):
    """The shared-prefix stream through the open two-replica gateway under
    a ``/v1/debug/profile`` capture (the fleet's device busy share; the
    profiler slows the host, so this pass's tokens/s is no fleet speed):
    every stream bitwise its direct one-replica submit, sticky dispatches
    and radix hits."""
    tel = gw.telemetry
    sticky0 = tel.counter_total("serving/dispatch/sticky")
    hits0 = [rep.scheduler.radix.hits for rep in gw.replicas]
    status, _, body = _http(gw.port, "POST", "/v1/debug/profile", {"duration_ms": 1500})
    check(status == 200, f"POST /v1/debug/profile answered {status}")
    path = os.path.join(json.loads(body)["path"], "capture.trace.json")
    res, wall = http_stream(gw.port, prompts, SERVE_NEW)
    for i, (status, toks, _, _) in enumerate(res):
        check(status == 200 and toks == direct[i].tolist(),
              f"fleet shared-prefix request {i}: the SSE stream differs from the direct submit")
    sticky = tel.counter_total("serving/dispatch/sticky") - sticky0
    hits = [rep.scheduler.radix.hits - h for rep, h in zip(gw.replicas, hits0)]
    check(sticky > 0 and sum(hits) > 0, f"fleet shared-prefix stream: {sticky} sticky dispatches, radix hits {hits}")
    n = sum(len(r[1]) for r in res)
    deadline = time.monotonic() + 60
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    check(os.path.exists(path), f"fleet shared-prefix stream: no profiler capture at {path} after 60 s")
    share = device_busy_share(path)
    check(share is not None, "fleet shared-prefix stream: the profiler capture holds no device kernel")
    log(f"fleet x2 shared-prefix stream ({len(prompts)} POSTs, under the profiler): {n} tokens in {wall:.3f} s, "
        f"{sticky} sticky dispatches of {len(prompts)}, radix hits per replica {hits}, streams bitwise the direct "
        f"submit; device busy {share[0]:.3f} ms of a {share[1]:.3f} ms torch.profiler capture (POST "
        f"/v1/debug/profile, 1.5 s) = {share[0] / share[1]:.4f}")


def fleet_serve(rs, prompts):
    """Dispatch every prompt at t = 0 (stepping the fleet while it is full),
    the odd ones sampled (``KV_SAMPLED``), and pump until all finish.
    Returns (streams, logits, TTFT ms, ITL ms, wall s)."""
    stamps = [[] for _ in prompts]
    handles = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        while True:
            _, h = rs.dispatch(p, max_new_tokens=SERVE_NEW, collect_logits=True, seed=100 + i,
                               on_token=lambda tok, done, i=i: stamps[i].append(time.perf_counter()),
                               **(KV_SAMPLED if i % 2 else {}))
            if h is not None:
                break
            rs.pump_once()
        handles.append(h)
    rs.drain_all_work()
    wall = time.perf_counter() - t0
    ttft = [(s[0] - t0) * 1e3 for s in stamps]
    itl = [(s[-1] - s[0]) * 1e3 / max(1, len(s) - 1) for s in stamps]
    return [h.result() for h in handles], [h.result_logits() for h in handles], ttft, itl, wall


def fleet_roles_leg(torch, card, eng, prompts):
    """``roles: ["prefill", "decode"]`` in process over one host store, the
    whole mixed stream at t = 0 (32 requests on 8 slots a replica: prompts
    queue for the prefill replica, handoffs for the decode replica): on the
    model's bf16 pool and an int8 pool, requests greedy and sampled in turn,
    every request's tokens and logits bitwise the one-replica run's, each
    migrated (out == in); each handoff's D2H and H2D by CUDA events on the
    tier's copy streams, its bytes; TTFT and ITL beside the one-replica
    (colocated) run of the same stream. Returns the bf16 one-replica run of
    the first ``ROUTER_PROMPTS`` requests for the router leg
    (``router_reference``'s shape)."""
    import numpy as np
    from deepspeed_tpu_torch.memory import GlobalPrefixStore
    from deepspeed_tpu_torch.serving.replica import Replica, ReplicaSet
    for kv in ("auto", "int8"):
        what = f"fleet roles ({'int8' if kv == 'int8' else 'bf16'} KV, greedy and sampled)"
        one = ReplicaSet([Replica(0, kv_scheduler(eng, kv_cache_dtype=kv))])
        ref_t, ref_l, ref_ttft, ref_itl, ref_wall = fleet_serve(one, prompts)
        if kv == "auto":  # the router leg's reference: its workers serve on this pool
            router_ref = (ref_t[:ROUTER_PROMPTS], [x[:ROUTER_LOGIT_STEPS] for x in ref_l[:ROUTER_PROMPTS]],
                          _widths(one.primary))
        del one
        store = GlobalPrefixStore(capacity_bytes=4 << 30)
        pair = [kv_scheduler(eng, kv_cache_dtype=kv, prefix_store=store) for _ in range(2)]
        rs = ReplicaSet([Replica(i, s) for i, s in enumerate(pair)], roles=["prefill", "decode"])
        for s in pair:
            s.kv_tier.executor.time_transfers = True
        got_t, got_l, ttft, itl, wall = fleet_serve(rs, prompts)
        same_t = all(np.array_equal(a, b) for a, b in zip(ref_t, got_t))
        same_l = all(np.array_equal(a, b) for a, b in zip(ref_l, got_l))
        moved = (pair[0].migrations_out, pair[1].migrations_in)
        check(same_t and same_l, f"{what}: tokens bitwise {same_t}, logits bitwise {same_l}")
        check(moved == (len(prompts), len(prompts)), f"{what}: migrations out / in {moved}")
        d2h = transfer_rates(torch, pair[0].kv_tier, "d2h")
        h2d = transfer_rates(torch, pair[1].kv_tier, "h2d")
        sizes = [n for k, n, _, _ in pair[0].kv_tier.executor.transfer_events if k == "d2h"]
        nbytes = statistics.median(sizes) if sizes else float("nan")
        log(f"{what}, the mixed stream's {len(prompts)} requests at t = 0, {SERVE_NEW} new, 8 slots a "
            f"replica: tokens and logits bitwise the one-replica run; migrations out / in {moved[0]} / "
            f"{moved[1]}; a handoff's D2H {d2h[1]:.4f} ms ({d2h[2]:.2f} GB/s, median of {d2h[0]}), H2D "
            f"{h2d[1]:.4f} ms ({h2d[2]:.2f} GB/s, median of {h2d[0]}), {nbytes / 1e6:.3f} MB median; wall "
            f"{wall:.3f} s (one replica {ref_wall:.3f}); TTFT p50 {_pct(ttft, 50):.1f} ms, p95 "
            f"{_pct(ttft, 95):.1f} (one replica {_pct(ref_ttft, 50):.1f}, {_pct(ref_ttft, 95):.1f}); ITL p50 "
            f"{_pct(itl, 50):.3f} ms, p95 {_pct(itl, 95):.3f} (one replica {_pct(ref_itl, 50):.3f}, "
            f"{_pct(ref_itl, 95):.3f}) on {card}")
        del rs, pair, store, ref_l, got_l
        torch.cuda.empty_cache()
    return router_ref


def fleet_failure_leg(gw, prompts, direct):
    """On the open two-replica gateway, its sticky index cleared (so
    least-loaded placement spreads the prompts over both replicas again):
    replica 1's step raises from its ``FLEET_FAIL_AFTER``-th call on, its
    requests fail, replica 0 serves the rest bitwise, replica 1 reads sick.
    The caller's close checks that the fleet drains."""
    gw.replicas._sticky.clear()
    sick = gw.replicas.replicas[1]
    real, calls = sick.scheduler.step, []

    def step():
        calls.append(1)
        if len(calls) >= FLEET_FAIL_AFTER:
            raise RuntimeError("planted step failure")
        return real()
    sick.scheduler.step = step
    res, _ = http_stream(gw.port, prompts, SERVE_NEW)
    ok = [i for i, r in enumerate(res) if r[0] == 200 and r[3] == "length"]
    for i in ok:
        check(res[i][1] == direct[i].tolist(), f"fleet failure leg: request {i} differs from direct submit")
    states = gw.replicas.states()
    check(0 < len(ok) < len(prompts), f"fleet failure leg: {len(ok)} of {len(prompts)} finished")
    check(states[1]["status"] == "sick" and states[0]["status"] == "active",
          f"fleet failure leg: replica states {[s['status'] for s in states]}")
    log(f"fleet failure leg (replica 1's step raising from its {FLEET_FAIL_AFTER}th call): "
        f"{len(prompts) - len(ok)} requests failed, {len(ok)} finished bitwise on replica 0; replica 1 "
        f"{states[1]['status']} ({states[1]['error']})")


def _fleet_record():
    """Every request the schedulers of this process make, in order."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    made, real = [], DecodeScheduler._make_request

    def make(self, *args, **kwargs):
        req = real(self, *args, **kwargs)
        made.append(req)
        return req
    DecodeScheduler._make_request = make
    return made


def _fleet_tp_sse(port, prompt, max_new, disconnect_after=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    toks = []
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [int(t) for t in prompt], "max_tokens": max_new, "stream": True}))
        resp = conn.getresponse()
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: {"):
                toks += json.loads(line[6:])["choices"][0]["token_ids"]
                if disconnect_after is not None and len(toks) >= disconnect_after:
                    break
        return resp.status, toks
    finally:
        conn.close()


def _fleet_tp_rank(rank, world, store, out_dir, dev):
    """One rank of the fleet's tp 2 leg (a spawned process): the gloo group
    over the card, the mesh (tensor = world), the int8 llama3-8b engine;
    rank 0 serves the gateway (the streams, then a client that disconnects
    mid-decode), the other rank follows. Results to
    ``out_dir/rank{rank}.pt``, a traceback to ``rank{rank}.err``."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        import threading
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        import deepspeed_tpu_torch
        import deepspeed_tpu_torch.comm as dist
        from deepspeed_tpu_torch.serving import Gateway, follow
        dist.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                              verbose=False)
        dist.initialize_mesh(tensor=world)
        model, tree = tp_int8_tree(torch, dev)
        config = {**TP_SERVE_CONFIG, "continuous_batching": {"enabled": True, "num_slots": FLEET_TP_SLOTS,
                                                               "steps_per_sync": 4}}
        eng = deepspeed_tpu_torch.init_inference(model, config=config, params=tree, device=dev)
        del tree
        made = _fleet_record()
        reset_counts()
        res = {}
        if rank == 0:
            _, stream = tp_prompts(eng.model_config.vocab_size)
            gw = Gateway(eng, port=0, request_timeout_s=600.0, drain_timeout_s=120.0).start_background(timeout=300)
            try:
                out = [None] * len(stream)

                def client(i):
                    out[i] = _fleet_tp_sse(gw.port, stream[i], FLEET_TP_NEW)
                threads = [threading.Thread(target=client, args=(i, )) for i in range(len(stream))]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
                res["wall"] = time.perf_counter() - t0
                res["streams"] = out
                rep = gw.replicas.replicas[0]
                real = rep.step

                def slow():
                    n = real()
                    time.sleep(0.02)
                    return n
                rep.step = slow  # the disconnect lands mid-decode
                res["disconnected"] = _fleet_tp_sse(gw.port, stream[0], FLEET_TP_DISCONNECT_NEW, disconnect_after=2)
                deadline = time.monotonic() + 120
                while (gw._active or rep.scheduler.cache.active_slots) and time.monotonic() < deadline:
                    time.sleep(0.01)
                res["freed"] = not gw._active and rep.scheduler.cache.active_slots == 0
            finally:
                res["drained"] = gw.close(timeout=120)
            res["fatal"] = gw._fatal
        else:
            res["rc"] = follow(eng)
        torch.cuda.synchronize()
        res["counts"] = read_counts()
        res["forwards"] = dict(eng._scheduler.forwards)
        res["reqs"] = [(r.rid, list(r.out), r.cancelled) for r in made]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def fleet_tp_leg(torch, card, dev):
    """llama3-8b (2 layers) int8 at tp 2, two processes sharing the card
    over gloo: rank 0 serves the gateway, rank 1 follows. 8 concurrent
    streams bitwise the tp 1 engine's direct submits (this process, the
    engine's own fused-qkv layout), exact launch counts on each rank (the
    tp 2 per-projection forwards), a client disconnecting mid-decode
    freeing the slot on both ranks (both ranks' requests, tokens and
    cancels equal), both ranks exiting 0. Returns one rank's launch
    counts."""
    import dataclasses
    import shutil
    import tempfile
    import deepspeed_tpu_torch
    import torch.multiprocessing as mp
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    model, tree = tp_int8_tree(torch, dev)
    eng = deepspeed_tpu_torch.init_inference(model, config=TP_SERVE_CONFIG,
                                             params=fuse_qkv(torch, tree, model.cfg.num_layers), device=dev)
    del tree
    _, stream = tp_prompts(eng.model_config.vocab_size)
    sched = DecodeScheduler(eng, num_slots=FLEET_TP_SLOTS, steps_per_sync=4)
    ref = [h.result().tolist() for h in [sched.submit(p, max_new_tokens=FLEET_TP_NEW) for p in stream]]
    cfg = dataclasses.replace(eng.model_config, int8_fused_qkv=False)
    del sched, eng
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_tp_")
    try:
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_fleet_tp_rank, args=(r, TP_DEGREE, os.path.join(tmp, "store"), tmp, dev))
                 for r in range(TP_DEGREE)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(TP_DEGREE)
                if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
        check(not alive, f"fleet tp: {len(alive)} rank(s) still running after {FLEET_TIMEOUT_S} s; killed")
        check(not errs, "fleet tp: a rank failed:\n" + "\n".join(errs))
        check(all(p.exitcode == 0 for p in procs), f"fleet tp: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(TP_DEGREE)]
        span = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = ranks
    check(r0["fatal"] is None and r0["drained"] and r1["rc"] == 0,
          f"fleet tp: fatal {r0['fatal']}, drained {r0['drained']}, follower {r1.get('rc')}")
    for i, (status, toks) in enumerate(r0["streams"]):
        check(status == 200 and toks == ref[i], f"fleet tp request {i}: the SSE stream is not tp 1's direct submit")
    L, per_forward = cfg.num_layers, 7 * cfg.num_layers + 1
    for r, res in enumerate(ranks):
        fw = res["forwards"]
        n1, nc = fw.get(1, 0), sum(v for c, v in fw.items() if c != 1)
        want = {**ZERO_COUNTS, "quant_matmul": per_forward * (n1 + nc), "paged_decode_attention": L * n1,
                "paged_span_attention": L * nc}
        check(res["counts"] == want, f"fleet tp rank {r} launches {res['counts']} != {want}")
    check(r0["forwards"] == r1["forwards"], f"fleet tp: forwards per rank {r0['forwards']} / {r1['forwards']}")
    status, toks = r0["disconnected"]
    check(status == 200 and len(toks) >= 2 and r0["freed"], f"fleet tp disconnect: {status}, {len(toks)} tokens, "
                                                             f"freed {r0['freed']}")
    check(sorted(r0["reqs"]) == sorted(r1["reqs"]), "fleet tp: the ranks' requests, tokens or cancels differ")
    rid, out, cancelled = r0["reqs"][-1]
    check(cancelled and len(out) < FLEET_TP_DISCONNECT_NEW, f"fleet tp: the disconnected request ran "
                                                            f"{len(out)} tokens, cancelled {cancelled}")
    n = sum(len(t) for _, t in r0["streams"])
    log(f"fleet tp {TP_DEGREE} ({TP_MODEL}, {cfg.num_layers} layers, int8, rank 0 serving HTTP, rank 1 following; "
        f"two processes sharing the card over gloo): {len(ref)} streams bitwise tp 1's direct submits, {n} tokens "
        f"in {r0['wall']:.3f} s (two processes sharing one card: not a tensor-parallel speed); launches exact on "
        f"both ranks {dict((k, v) for k, v in r0['counts'].items() if v)}; the disconnected request stopped at "
        f"{len(out)} of {FLEET_TP_DISCONNECT_NEW} tokens on both ranks; both ranks exited 0; {span:.1f} s")
    return r0["counts"]


# ---------------------------------------------------------------------------
# the fleet's router leg: the multi-host router and its workers, each one
# process of ``python -m deepspeed_tpu_torch.serving`` on this card


ROUTER_PROMPTS = 8        # the mixed stream's first 8: greedy (even) and sampled (odd), as fleet_serve's
ROUTER_LOGIT_STEPS = 8    # a unary request's new tokens: the prefill side's last sync gives 4 at K = 4
ROUTER_KILL_NEW = 48
ROUTER_START_S = 900
ROUTER_HASH_SEED = "0"    # the routers' PYTHONHASHSEED: a tie of two workers breaks on hash(wid)
ROUTER_HOST_MB = 1024
ROUTER_WORKER_ARGS = []   # ["--device", "cpu"] rehearses the leg on the host


def _router_wids():
    """Two worker ids in different tie-break classes of a router run with
    ``PYTHONHASHSEED=ROUTER_HASH_SEED`` (two idle workers tie on their
    load score and break it on ``hash(wid) mod 3``), so the requests
    placed at once on an idle pair go to both."""
    code = "import json; print(json.dumps([hash(f'w{i}') % 3 for i in range(16)]))"
    out = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONHASHSEED": ROUTER_HASH_SEED},
                         capture_output=True, text=True, check=True, timeout=60).stdout
    cls = json.loads(out)
    return "w0", f"w{next(i for i in range(1, 16) if cls[i] != cls[0])}"


def _build_snapshot():
    """{library: mtime} of the kernels built in ``ops/_build``."""
    from deepspeed_tpu_torch.ops.build import BUILD_DIR
    if not os.path.isdir(BUILD_DIR):
        return {}
    return {n: os.path.getmtime(os.path.join(BUILD_DIR, n)) for n in os.listdir(BUILD_DIR)}


class RouterFleet:
    """Two routers and four workers, started at once: router A over two
    ``mixed`` workers, router B over a ``prefill`` and a ``decode`` worker;
    each worker serves ``FLEET_MODEL`` at full width and depth
    (``SERVE_CONFIG`` with the hierarchical KV tier, weights from seed 0)
    with the kernels this process built. ``stop()`` ends every process and
    returns their exit codes."""

    def __init__(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="router_leg_")
        self.procs = {}    # name -> (Popen, log path)
        self.ready = {}    # name -> its READY line
        self.ports = {}
        self.workers = {}  # wid -> (router, role)
        self.t0 = self.t_ready = None
        self.built = None
        self.router_mib = None  # the card's memory the routers took (a CUDA context is ~0.5 GiB)

    def _spawn(self, name, args, env=None, nice=0):
        path = os.path.join(self.dir, name + ".log")
        with open(path, "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.serving", *args], cwd=ROOT,
                                    stdout=f, stderr=subprocess.STDOUT, env={**os.environ, **(env or {})},
                                    preexec_fn=(lambda: os.nice(nice)) if nice else None)
        self.procs[name] = (proc, path)

    def _wait(self, name, token, deadline):
        proc, path = self.procs[name]
        while True:
            with open(path) as f:
                text = f.read()
            for line in text.splitlines():
                if line.startswith("{") and f'"{token}"' in line:
                    self.ready[name] = json.loads(line)
                    return self.ready[name]
            tail = "\n".join(text.splitlines()[-30:])
            check(proc.poll() is None, f"router leg: {name} exited ({proc.returncode}) before {token}:\n{tail}")
            check(time.monotonic() < deadline, f"router leg: no {token} from {name} in {ROUTER_START_S} s:\n{tail}")
            time.sleep(0.2)

    def start(self):
        """The routers (no model, no device), then the workers at niceness
        10: they build their weights on the host while this process's own
        legs run."""
        self.t0 = time.perf_counter()
        self.built = _build_snapshot()
        cb = {**SERVE_CONFIG["continuous_batching"],
              "hierarchical_kv": {"enabled": True, "host_capacity_mb": ROUTER_HOST_MB}}
        cfg = {**SERVE_CONFIG, "continuous_batching": cb,
               "gateway": {"max_queue_depth": 64, "request_timeout_s": 600.0, "drain_timeout_s": 120.0}}
        path = os.path.join(self.dir, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        used0 = _card_used_mib()
        for r in ("router_a", "router_b"):
            self._spawn(r, ["--router", "--port", "0", "--heartbeat-timeout-s", "30"],
                        env={"PYTHONHASHSEED": ROUTER_HASH_SEED})
        deadline = time.monotonic() + ROUTER_START_S
        self.ports = {r: self._wait(r, "ROUTER_READY", deadline)["port"] for r in ("router_a", "router_b")}
        if used0 is not None:
            self.router_mib = _card_used_mib() - used0
        a0, a1 = _router_wids()
        self.workers = {a0: ("router_a", "mixed"), a1: ("router_a", "mixed"),
                        "prefill": ("router_b", "prefill"), "decode": ("router_b", "decode")}
        for wid, (r, role) in self.workers.items():
            self._spawn(wid, ["--worker", "--router-url", f"http://127.0.0.1:{self.ports[r]}", "--worker-id", wid,
                              "--worker-role", role, "--model", FLEET_MODEL, "--config", path, "--port", "0",
                              "--heartbeat-s", "0.5", "--lease-s", "600", *ROUTER_WORKER_ARGS], nice=10)
        return self

    def wait_ready(self):
        """Every worker's GATEWAY_READY, and both live at their router."""
        deadline = time.monotonic() + ROUTER_START_S
        for wid in self.workers:
            self._wait(wid, "GATEWAY_READY", deadline)
        for r, port in self.ports.items():
            while True:
                live = [w["wid"] for w in json.loads(_http(port, "GET", "/v1/workers")[2])["workers"]
                        if w["status"] == "active"]
                if len(live) == 2:
                    break
                check(time.monotonic() < deadline, f"router leg: {r} has live workers {live}")
                time.sleep(0.2)
        self.t_ready = time.perf_counter() - self.t0
        return self

    def pid(self, name):
        return self.procs[name][0].pid

    def stop(self):
        import shutil
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        codes = {}
        for name, (proc, _) in self.procs.items():
            try:
                codes[name] = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                codes[name] = proc.wait(timeout=60)
        shutil.rmtree(self.dir, ignore_errors=True)
        return codes


def _router_body(prompts, i, stream, max_new=None):
    """Request ``i`` of the leg as ``fleet_serve`` makes it (seed 100 + i,
    the odd ones sampled): a stream of ``SERVE_NEW`` tokens, or a unary
    reply of ``ROUTER_LOGIT_STEPS`` tokens with its logits."""
    body = {"prompt": [int(t) for t in prompts[i]], "seed": 100 + i, **(KV_SAMPLED if i % 2 else {})}
    if stream:
        body.update(stream=True, max_tokens=max_new or SERVE_NEW)
    else:
        body.update(return_logits=True, max_tokens=max_new or ROUTER_LOGIT_STEPS)
    return body


def _router_unary(port, body):
    import numpy as np
    status, _, raw = _http(port, "POST", "/v1/completions", body)
    check(status == 200, f"router leg: a unary request answered {status}: {raw[:300]!r}")
    doc = json.loads(raw)
    check("handoff" not in doc, "router leg: a unary reply carried a handoff")
    return doc["choices"][0]["token_ids"], np.asarray(doc.get("logits", []), np.float32)


def _router_sse(port, body):
    status, _, raw = _http(port, "POST", "/v1/completions", body)
    check(status == 200, f"router leg: a stream answered {status}: {raw[:300]!r}")
    toks, done, handoff = [], False, False
    for line in raw.decode().splitlines():
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            ev = json.loads(line[6:])
            handoff = handoff or "handoff" in ev
            toks += ev.get("choices", [{}])[0].get("token_ids", [])
    return toks, done, handoff


def _run_clients(calls):
    """Every ``(key, fn, args)`` from its own thread, all at once; returns
    {key: result}, raising the first failure."""
    import threading
    out, errs = {}, []

    def run(key, fn, args):
        try:
            out[key] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)
    threads = [threading.Thread(target=run, args=c, daemon=True) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
        check(not t.is_alive(), "router leg: a client thread did not finish within 900 s")
    if errs:
        raise errs[0]
    return out


def _card_used_mib():
    """The card's memory in use (MiB) as nvidia-smi reads it, or None
    without nvidia-smi (a rehearsal on the host)."""
    import shutil
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return int(out.split()[0])


def router_leg(torch, card, rf, prompts, ref_t, ref_l, ref_widths, direct=None):
    """The multi-host router over ``rf``'s processes, against this process's
    run of the same requests (``fleet_serve``: ``ref_t`` tokens, ``ref_l``
    the first ``ROUTER_LOGIT_STEPS`` logits, ``ref_widths`` its forward
    widths). First, request 0 through router A bitwise: the workers' seed-0
    weights are this process's. Then, all at once: (a) the first
    ``ROUTER_PROMPTS`` requests through router A (the rest of the unary
    replies with logits, and every request streamed): tokens and logits
    bitwise, both workers placed, no handoff event; (c) the same through
    router B, every request crossing from the prefill worker to the decode
    worker: bitwise, ``handoff_resumes`` >= the requests. (b) a prefix
    flushed from worker A0's radix restores on A1 bitwise, A1's
    ``remote_restores`` and ``net_bytes_in`` rising; (d) each worker's
    forward widths within this process's; each process's peak device
    memory; no worker rebuilt a kernel; (e) last, router A's worker holding
    a ``ROUTER_KILL_NEW``-token stream is SIGKILLed after its first event:
    the stream ends without ``[DONE]``, ``worker_sick`` >= 1, the survivor
    serves within 120 s. Returns the workers' forward counts."""
    import http.client
    import signal
    import numpy as np
    rf.wait_ready()
    log(f"router leg: 2 routers and 4 workers ({FLEET_MODEL}, {SERVE_CONFIG['dtype']}) live {rf.t_ready:.1f} s "
        f"after their start")
    t0 = time.perf_counter()
    pa, pb = rf.ports["router_a"], rf.ports["router_b"]
    a0, a1 = [w for w, (r, _) in rf.workers.items() if r == "router_a"]
    wport = {w: rf.ready[w]["port"] for w in rf.workers}
    n = ROUTER_PROMPTS
    if direct is not None:
        check(all(np.array_equal(direct[i], ref_t[i]) for i in range(0, n, 2)),
              "router leg: the greedy references differ from the direct streams")

    def same(i, toks, logits=None):
        ok = toks == [int(t) for t in ref_t[i][:len(toks)]]
        if logits is not None:
            ok = ok and logits.shape == ref_l[i][:len(toks)].shape and np.array_equal(logits, ref_l[i][:len(toks)])
        return ok

    toks, logits = _router_unary(pa, _router_body(prompts, 0, False))
    check(len(toks) == ROUTER_LOGIT_STEPS and same(0, toks, logits),
          "router leg: a worker's first reply is not bitwise this process's on the same seed-0 weights: "
          f"tokens {toks} vs {ref_t[0][:len(toks)].tolist()}")
    log(f"router leg: request 0 through router A bitwise this process's (tokens and {logits.shape} logits): "
        f"the workers hold the same seed-0 weights")
    calls = [(("a", "unary", i), _router_unary, (pa, _router_body(prompts, i, False))) for i in range(1, n)]
    for tag, port in (("a", pa), ("b", pb)):
        calls += [((tag, "sse", i), _router_sse, (port, _router_body(prompts, i, True))) for i in range(n)]
    calls += [(("b", "unary", i), _router_unary, (pb, _router_body(prompts, i, False))) for i in range(n)]
    t1 = time.perf_counter()
    res = _run_clients(calls)
    burst = time.perf_counter() - t1
    for (tag, mode, i), r in sorted(res.items()):
        what = f"router leg ({'a' if tag == 'a' else 'c'}): request {i} ({mode}) through router {tag.upper()}"
        if mode == "unary":
            check(len(r[0]) == ROUTER_LOGIT_STEPS and same(i, r[0], r[1]), f"{what}: not bitwise this process's")
        else:
            check(r[2] is False, f"{what}: a handoff event reached the client")
            check(r[1] and len(r[0]) == SERVE_NEW and same(i, r[0]), f"{what}: not bitwise this process's")
    ma, mb = (json.loads(_http(p, "GET", "/v1/metrics")[2]) for p in (pa, pb))
    routed = {w["wid"]: w["routed"] for w in ma["workers"]}
    check(all(routed.get(w, 0) > 0 for w in (a0, a1)), f"router leg (a): placements {routed}")
    check(mb["router"]["handoff_resumes"] >= 2 * n, f"router leg (c): handoff_resumes {mb['router']['handoff_resumes']}")
    wm = {w: json.loads(_http(p, "GET", "/v1/metrics")[2]) for w, p in wport.items()}
    out_b, in_b = wm["prefill"]["net_store"]["net_bytes_out"], wm["decode"]["net_store"]["net_bytes_in"]
    handoffs = wm["prefill"]["gateway"]["handoffs_out"]
    check(handoffs >= 2 * n and wm["decode"]["gateway"]["resumed_in"] >= 2 * n,
          f"router leg (c): handoffs out {handoffs}, resumed in {wm['decode']['gateway']['resumed_in']}")
    log(f"router leg (a), (c): {len(calls) + 1} requests ({n} unary with {ROUTER_LOGIT_STEPS} steps of logits "
        f"and {n} streams of {SERVE_NEW} a router, greedy and sampled) bitwise this process's run in "
        f"{burst:.3f} s; router A placed {routed}; router B: {mb['router']['handoff_resumes']} handoff resumes, "
        f"{handoffs} handoffs out, {out_b} bytes out of the prefill worker's shard and {in_b} into the decode "
        f"worker's ({out_b / max(1, handoffs) / 1e6:.3f} MB a handoff); no handoff event reached a client")
    # (b) the cross-host prefix restore, on a prompt no request has sent, of
    # two chunks or more (a restore moves whole chunks)
    chunk = SERVE_CONFIG["continuous_batching"].get("prefill_chunk", 64)
    rb = next(i for i in range(n, len(prompts)) if len(prompts[i]) >= 2 * chunk)
    body = _router_body(prompts, rb, False)
    first = _router_unary(wport[a0], body)
    status, _, raw = _http(wport[a0], "POST", "/v1/debug/flush_radix", {})
    check(status == 200 and json.loads(raw) == {"flushed": True}, f"router leg (b): flush answered {status} {raw!r}")
    before = json.loads(_http(wport[a1], "GET", "/v1/metrics")[2])["net_store"]
    again = _router_unary(wport[a1], body)
    after = json.loads(_http(wport[a1], "GET", "/v1/metrics")[2])["net_store"]
    check(first[0] == again[0] and np.array_equal(first[1], again[1]),
          "router leg (b): the restored prefix's reply is not bitwise the owner's")
    rose = (after["remote_restores"] - before["remote_restores"], after["net_bytes_in"] - before["net_bytes_in"])
    check(rose[0] > 0 and rose[1] > 0, f"router leg (b): remote restores / bytes in rose by {rose}")
    log(f"router leg (b): request {rb} ({len(prompts[rb])} tokens) on {a0}, its radix flushed to its shard, "
        f"then on {a1}: bitwise, "
        f"{rose[0]} remote restore(s), {rose[1]} bytes fetched")
    # (d) forward widths, device memory, the kernels' build
    counts = {}
    for w, p in wport.items():
        m = json.loads(_http(p, "GET", "/v1/metrics")[2])
        fw = m["scheduler"]["forward_widths"]
        counts[w] = fw
        for kind in ("forwards", "ext_forwards"):
            check(set(fw[kind]) <= set(ref_widths[kind]),
                  f"router leg (d): {w}'s {kind} widths {sorted(fw[kind])} not within {sorted(ref_widths[kind])}")
        dev = m["device"]
        peak = dev["peak_allocated_bytes"] / 2**30 if dev else float("nan")
        counts[w] = dict(fw, peak_gib=round(peak, 3))
    check(rf.router_mib is None or rf.router_mib < 256,
          f"router leg: the card's memory rose {rf.router_mib} MiB as the two routers started (a CUDA context)")
    check(_build_snapshot() == rf.built, "router leg (d): a worker process rebuilt a kernel library")
    log(f"router leg (d): forward widths and counts within this process's {ref_widths}: "
        + "; ".join(f"{w} {c}" for w, c in counts.items())
        + f"; peak device memory allocated a worker (GiB) {[counts[w]['peak_gib'] for w in wport]}; the card's "
        f"memory in use rose {rf.router_mib} MiB as the routers started (no CUDA context); no worker rebuilt a "
        f"kernel; on {card}")
    # (e) a worker killed mid-stream, last
    before = {w["wid"]: w["routed"] for w in json.loads(_http(pa, "GET", "/v1/workers")[2])["workers"]}
    probe = _router_body(prompts, rb + 1, True, max_new=1)
    _router_sse(pa, probe)
    after = {w["wid"]: w["routed"] for w in json.loads(_http(pa, "GET", "/v1/workers")[2])["workers"]}
    (victim, ) = [w for w in after if after[w] > before.get(w, 0)]
    survivor = a1 if victim == a0 else a0
    conn = http.client.HTTPConnection("127.0.0.1", pa, timeout=600)
    try:
        conn.request("POST", "/v1/completions", json.dumps(dict(probe, max_tokens=ROUTER_KILL_NEW)),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"router leg (e): the stream answered {resp.status}")
        first = resp.fp.readline()
        os.kill(rf.pid(victim), signal.SIGKILL)
        raw = first + resp.fp.read()
    finally:
        conn.close()
    check(first.startswith(b"data:") and b"data: [DONE]" not in raw,
          "router leg (e): the killed worker's stream was not cut short")
    t_kill = time.perf_counter()
    while True:
        status, _, rawb = _http(pa, "POST", "/v1/completions", _router_body(prompts, rb + 2, False, max_new=4))
        if status == 200:
            break
        check(time.perf_counter() - t_kill < 120, f"router leg (e): no request served within 120 s ({status})")
        time.sleep(0.5)
    served = time.perf_counter() - t_kill
    m = json.loads(_http(pa, "GET", "/v1/metrics")[2])
    states = {w["wid"]: w["status"] for w in m["workers"]}
    check(m["router"]["worker_sick"] >= 1 and states[victim] == "sick" and states[survivor] == "active",
          f"router leg (e): worker_sick {m['router']['worker_sick']}, states {states}")
    n_tok = raw.count(b'"token_ids": [')
    log(f"router leg (e): {victim} SIGKILLed after its first event of {ROUTER_KILL_NEW}: the stream ended after "
        f"{n_tok} events without [DONE]; worker_sick {m['router']['worker_sick']}, {victim} {states[victim]}, "
        f"{survivor} {states[survivor]}, a new request served in {served:.3f} s")
    log(f"router leg: the gates {time.perf_counter() - t0:.1f} s; wall since the processes started "
        f"{time.perf_counter() - rf.t0:.1f} s on {card}")
    return counts, victim


def router_reference(eng, prompts):
    """This process's run of the router leg's requests (``fleet_serve`` on
    one replica of the serving shape): (tokens, the first
    ``ROUTER_LOGIT_STEPS`` logits, its forward widths)."""
    from deepspeed_tpu_torch.serving.replica import Replica, ReplicaSet
    one = ReplicaSet([Replica(0, kv_scheduler(eng))])
    toks, logits, _, _, _ = fleet_serve(one, prompts[:ROUTER_PROMPTS])
    return toks, [x[:ROUTER_LOGIT_STEPS] for x in logits], _widths(one.primary)


def _widths(sched):
    return {kind: sorted(str(w) for w in getattr(sched, kind)) for kind in ("forwards", "ext_forwards")}


def router_phase(torch, card):
    """``--router``: the router leg alone, its reference this process's own
    engine on the same seed-0 weights (built while the workers build
    theirs)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.telemetry import set_sink
    rf = RouterFleet()
    try:
        rf.start()
        set_sink(None)
        eng = deepspeed_tpu_torch.init_inference(FLEET_MODEL, config=SERVE_CONFIG)
        vocab = eng.model_config.vocab_size
        prompts = [p % vocab for p in mixed_stream()]
        ref = router_reference(eng, prompts)
        del eng
        torch.cuda.empty_cache()
        _, victim = router_leg(torch, card, rf, prompts, *ref)
    finally:
        codes = rf.stop()
    check(all(c == (-9 if name == victim else 0) for name, c in codes.items()),
          f"router leg: exit codes {codes}")
    log(f"router leg: every process ended (exit codes {codes})")


def fleet_phase(torch, card, params=None, one_replica=None, shared_direct=None):
    """gpt2-large int8 (``SERVE_CONFIG``: 8 slots x 512, K = 4, chunk 64, at
    full depth) as a fleet, on ``params`` (the fused engine's; else seed 0
    random weights): (a) the mixed stream's 32 concurrent streaming POSTs
    through a gateway of one replica and of two (``fleet_http_leg``; with
    ``one_replica``, the gateway phase's (HTTP tokens/s, direct streams) of
    the same stream on the same weights, one replica is not served again), (b)
    the shared-prefix stream through the two (``fleet_shared_leg``; with
    ``shared_direct``, the serving phase's streams of it are the reference),
    (d) a step failure planted on replica 1 of the same gateway
    (``fleet_failure_leg``), (c) ``["prefill", "decode"]`` in process on the
    whole mixed stream (``fleet_roles_leg``); the multi-host router leg
    (``router_leg``: two routers and four worker processes, started with
    the phase so they build their weights meanwhile, against (c)'s
    one-replica run); then (e) the gateway at tp 2 on llama3-8b
    (``fleet_tp_leg``). Returns each kernel's launches over (a)'s
    two-replica stream and (e)'s rank."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.telemetry import set_sink
    import shutil
    import tempfile
    rf = RouterFleet()
    try:
        rf.start()
        tel_dir = tempfile.mkdtemp(prefix="fleet_telemetry_")
        config = {**SERVE_CONFIG,
                  "telemetry": {"enabled": True, "output_path": tel_dir, "flush_interval": 1000,
                                "capacity_sample_every": GATEWAY_SAMPLE_EVERY},
                  "gateway": {"port": 0, "max_queue_depth": 64, "request_timeout_s": 600.0,
                              "drain_timeout_s": 120.0}}
        set_sink(None)
        eng = deepspeed_tpu_torch.init_inference(FLEET_MODEL, config=config, params=params)
        vocab = eng.model_config.vocab_size
        prompts = [p % vocab for p in mixed_stream()]
        warm = np.random.default_rng(SEED + 99).integers(0, vocab, 40).astype(np.int32)
        sched = eng.scheduler()
        shared = [p % vocab for p in shared_prefix_stream(sched)[0]]
        rates = {}
        if one_replica is None or shared_direct is None:
            serve(sched, [warm], max_new=8)
        if one_replica is None:
            direct, _, wall_direct, _, _ = serve(sched, prompts)
            log(f"fleet reference: the mixed stream by direct submit on one replica "
                f"{sum(len(o) for o in direct) / wall_direct:.1f} tokens/s")
        else:
            rates[1], direct = one_replica
            log(f"fleet: one replica over HTTP {rates[1]:.1f} tokens/s and the direct streams from the gateway "
                f"phase")
        if shared_direct is None:
            shared_direct, _, _, _, _ = serve(sched, shared)
        eng._scheduler = sched = None
        torch.cuda.empty_cache()
        for replicas in [n for n in (1, FLEET_REPLICAS) if n not in rates]:
            rates[replicas], counts, gw = fleet_http_leg(torch, card, eng, prompts, direct, warm, replicas)
            try:
                if replicas > 1:
                    fleet_shared_leg(gw, shared, shared_direct)
                    fleet_failure_leg(gw, prompts[:8], direct)
            finally:
                check(gw.close(timeout=120), f"fleet x{replicas}: the gateway did not drain")
        log(f"fleet HTTP tokens/s: one replica {rates[1]:.1f}, two {rates[FLEET_REPLICAS]:.1f} "
            f"({rates[FLEET_REPLICAS] / rates[1]:.3f}x) on {card}")
        eng._scheduler = None
        torch.cuda.empty_cache()
        router_ref = fleet_roles_leg(torch, card, eng, prompts)
        eng.telemetry.close()
        set_sink(None)
        shutil.rmtree(tel_dir, ignore_errors=True)
        del eng
        torch.cuda.empty_cache()
        _, victim = router_leg(torch, card, rf, prompts, *router_ref, direct=direct)
    finally:
        codes = rf.stop()
    check(all(c == (-9 if name == victim else 0) for name, c in codes.items()), f"router leg: exit codes {codes}")
    log(f"router leg: every process ended (exit codes {codes})")
    tp_counts = fleet_tp_leg(torch, card, torch.device("cuda"))
    return counts, tp_counts


# ---------------------------------------------------------------------------
# phase 4c: the hierarchical KV tier (host RAM and NVMe under the radix cache)


KV_HOST_MB, KV_NVME_HOST_MB = 4096, 256
KV_PREFIXES, KV_NEW, KV_GATED = 16, 64, 4
KV_SAMPLED = {"do_sample": True, "temperature": 0.8, "top_k": 50, "top_p": 0.95}


def kv_tier_streams(sched, vocab, seed=SEED):
    """16 distinct system prefixes of 6 chunks (384 tokens at chunk 64), each
    with two distinct half-chunk suffixes (32 tokens): pass 1's prompts and
    pass 2's revisits."""
    import numpy as np
    rng = np.random.default_rng(seed + 19)
    C = sched.prefill_chunk
    systems = [rng.integers(0, vocab, 6 * C) for _ in range(KV_PREFIXES)]
    passes = [[np.concatenate([s, rng.integers(0, vocab, C // 2)]).astype(np.int32) for s in systems]
              for _ in range(2)]
    check(all(a[6 * C] != b[6 * C] for a, b in zip(*passes)), "kv tier: two suffixes share a first token")
    return passes


def kv_scheduler(eng, **kw):
    """A scheduler with the engine's continuous-batching shape (slots, K,
    chunk) and ``kw``, built directly: no store unless ``kw`` gives one."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    cb = eng._config.continuous_batching
    return DecodeScheduler(eng, num_slots=cb.num_slots, steps_per_sync=cb.steps_per_sync,
                           prefill_chunk=cb.prefill_chunk, **kw)


def kv_gate_kw(j):
    """The j-th gated request's settings: logits collected, every second
    one sampled, seeded by j (the same in every run it is compared across)."""
    return {"collect_logits": True, "seed": 100 + j, **(KV_SAMPLED if j % 2 else {})}


def kv_serve(sched, prompts, gated=(), max_new=KV_NEW):
    """Queue every prompt at t = 0 and pump until all finish; the request
    at index ``gated[j]`` runs with ``kv_gate_kw(j)``. Returns (streams,
    {index: logits} of the gated, TTFT ms, wall s)."""
    kws = {i: kv_gate_kw(j) for j, i in enumerate(gated)}
    hs = [sched.submit(p, max_new_tokens=max_new, **kws.get(i, {})) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    while any(not h.done for h in hs):
        sched.step()
    wall = time.perf_counter() - t0
    ttft = [(h._req.first_token_ts - h._req.submit_ts) * 1e3 for h in hs]
    return [h.result() for h in hs], {i: hs[i].result_logits() for i in gated}, ttft, wall


def transfer_rates(torch, tier, kind):
    """(count, median ms, median GB/s) of the tier's ``kind`` copies ("d2h":
    demotes, "h2d": restores) timed by CUDA events on the copy streams."""
    torch.cuda.synchronize()
    ev = [(n, s.elapsed_time(e)) for k, n, s, e in tier.executor.transfer_events if k == kind]
    if not ev:
        return 0, float("nan"), float("nan")
    ms = statistics.median(t for _, t in ev)
    return len(ev), ms, statistics.median(n / t / 1e6 for n, t in ev if t > 0)


def three_way(tokens, logits, what):
    """Every run's streams and gated logits bitwise the first run's."""
    import numpy as np
    (name0, t0), l0 = tokens[0], logits[0][1]
    for (name, t), (_, lg) in zip(tokens[1:], logits[1:]):
        same_t = all(np.array_equal(a, b) for a, b in zip(t0, t))
        same_l = all(np.array_equal(l0[i], lg[i]) for i in l0)
        log(f"{what}: {name} vs {name0}: tokens bitwise {same_t}, logits bitwise {same_l}")
        check(same_t and same_l, f"{what}: {name} differs from {name0}")


def kv_host_leg(torch, card, eng, store_kw=None, ref=None):
    """(a) The host tier (``eng.scheduler()``, built from the config's
    ``hierarchical_kv``; with ``store_kw`` a scheduler over its own store
    instead, leg (b)): pass 1 computes 16 prompts cold (the 8-slot pool
    demotes them), pass 2 revisits every prefix with a new suffix and must
    restore each from the host tier, launching L x 6 span-kernel calls fewer
    a prefix than its cold prefill; exact launch counts and the radix
    invariants after each pass. Without ``ref``: the last 4 revisits
    (collected, greedy and sampled) against their device hits and a cold
    run with the tier off, bitwise. With ``ref`` (leg (b)): both passes'
    streams and the gated logits bitwise ``ref``'s. Returns a dict of the
    passes' prompts, streams and TTFTs, the gated logits and the scheduler."""
    import numpy as np
    from deepspeed_tpu_torch.memory import GlobalPrefixStore
    what = "kv tier (b) NVMe" if store_kw else "kv tier (a) host"
    vocab = eng.model_config.vocab_size
    if store_kw is None:
        sched = eng.scheduler()
    else:
        store = GlobalPrefixStore(telemetry=eng.telemetry, **store_kw)
        sched = kv_scheduler(eng, prefix_store=store)
    tier = sched.kv_tier
    check(tier is not None, f"{what}: the scheduler has no KV tier")
    check(sched._fused_block, f"{what}: fused gate closed ({sched._fused_block_reasons})")
    L = eng.model_config.num_layers
    p1, p2 = kv_tier_streams(sched, vocab)
    gated = tuple(range(KV_PREFIXES - KV_GATED, KV_PREFIXES))
    warm = (p1[0][:sched.prefill_chunk + 8] + 1) % vocab
    kv_serve(sched, [warm], max_new=8)  # first-use costs
    tier.warmup()  # the staging: allocated before the timed passes
    tier.executor.time_transfers = True
    tel = eng.telemetry
    gap = lambda b: tel.counter_total(f"serving/host_gap/{b}_ms")  # noqa: E731
    passes = []
    for n, prompts in ((1, p1), (2, p2)):
        sched.forwards.clear()
        r0, h0, d0, g0 = tier.restores, sched.radix.hits, tier.demotes, (gap("tier_transfer"),
                                                                          gap("admission"))
        reset_counts()
        outs, lg, ttft, wall = kv_serve(sched, prompts, gated if n == 2 else ())
        torch.cuda.synchronize()
        counts = read_counts()
        check_serve_counts(sched, counts, f"{what} pass {n}")
        check_streams(outs, KV_NEW, vocab, f"{what} pass {n}")
        sched.radix.check_invariants()  # joins the demotes in flight
        nc = sum(v for c, v in sched.forwards.items() if c != 1)
        passes.append((outs, lg, ttft, wall, nc, counts))
        log(f"{what} pass {n} ({KV_PREFIXES} prompts of {len(prompts[0])} tokens, {KV_NEW} new, 8 slots x "
            f"{sched.max_len}, K=4, chunk {sched.prefill_chunk}): {wall:.3f} s, TTFT p50 "
            f"{_pct(ttft, 50):.1f} ms, p95 {_pct(ttft, 95):.1f} ms; restores {tier.restores - r0}, "
            f"device hits {sched.radix.hits - h0}, demotes {tier.demotes - d0}; chunk forwards {nc}; "
            f"host gap in tier_transfer {gap('tier_transfer') - g0[0]:.1f} ms of admission "
            f"{gap('admission') - g0[1]:.1f} ms; on {card}")
        if n == 1:
            check(tier.demotes - d0 >= KV_PREFIXES - 8, f"{what}: pass 1 demoted {tier.demotes - d0}")
        else:
            check(tier.restores - r0 == KV_PREFIXES and sched.radix.hits == h0,
                  f"{what}: pass 2 restored {tier.restores - r0} of {KV_PREFIXES} (device hits "
                  f"{sched.radix.hits - h0})")
    (out1, _, ttft1, _, nc1, c1), (out2, lg2, ttft2, _, nc2, c2) = passes
    fewer = c1["paged_span_attention"] - c2["paged_span_attention"]
    check(nc1 - nc2 == 6 * KV_PREFIXES and fewer == L * 6 * KV_PREFIXES,
          f"{what}: pass 2 ran {nc1 - nc2} chunk forwards ({fewer} span launches) fewer than pass 1, "
          f"expected {6 * KV_PREFIXES} ({L * 6 * KV_PREFIXES})")
    st = tier.store.stats()
    nd, dms, dgb = transfer_rates(torch, tier, "d2h")
    nh, hms, hgb = transfer_rates(torch, tier, "h2d")
    log(f"{what}: TTFT p50/p95 pass 2 (restored) {_pct(ttft2, 50):.1f}/{_pct(ttft2, 95):.1f} ms against "
        f"pass 1 (cold) {_pct(ttft1, 50):.1f}/{_pct(ttft1, 95):.1f} ms; {L} x 6 fewer span launches a "
        f"restored prefix ({fewer} over {KV_PREFIXES}); demotes {tier.demotes}, restores {tier.restores}, "
        f"restored tokens {tier.restored_tokens}; kv_tier_hit_rate {tier.hit_rate(sched.radix):.4f}; "
        f"host tier {st['host_bytes'] / 2**20:.1f} MiB in {st['entries']} entries, NVMe "
        f"{st['nvme_bytes'] / 2**20:.1f} MiB; a demote's D2H {dms:.3f} ms = {dgb:.2f} GB/s (median of "
        f"{nd}), a restore's H2D {hms:.3f} ms = {hgb:.2f} GB/s (median of {nh}), CUDA events; {card}")
    res = {"p1": p1, "p2": p2, "out1": out1, "out2": out2, "lg2": lg2, "ttft2": ttft2,
           "gated": gated, "sched": sched}
    if ref is not None:
        same = (all(np.array_equal(a, b) for a, b in zip(out1, ref["out1"]))
                and all(np.array_equal(a, b) for a, b in zip(out2, ref["out2"]))
                and all(np.array_equal(lg2[i], ref["lg2"][i]) for i in gated))
        log(f"{what}: both passes' streams and the gated logits bitwise leg (a)'s: {same}")
        check(same, f"{what}: streams differ from the host tier's")
        return res
    # the gated revisits again: device hits now
    sel = [p2[i] for i in gated]
    regate = tuple(range(KV_GATED))
    h0 = sched.radix.hits
    hit_out, hit_lg, _, _ = kv_serve(sched, sel, regate)
    check(sched.radix.hits - h0 == KV_GATED, f"{what}: {sched.radix.hits - h0} device hits of {KV_GATED}")
    sched.radix.check_invariants()
    cold = kv_scheduler(eng)  # no store: the tier off
    cold_out, cold_lg, _, _ = kv_serve(cold, sel, regate)
    del cold
    restored = ([out2[i] for i in gated], {j: lg2[i] for j, i in enumerate(gated)})
    three_way([("restored", restored[0]), ("device hit", hit_out), ("cold, tier off", cold_out)],
              [("restored", restored[1]), ("device hit", hit_lg), ("cold, tier off", cold_lg)],
              f"{what}, bf16 KV, {KV_GATED} requests (greedy and sampled)")
    return res


def kv_int8_gate(torch, eng, prompts):
    """The 3-way gate on an int8 pool: ``prompts`` (greedy and sampled)
    cold with the tier, restored after 8 short requests demoted them, then
    device hits, and cold with the tier off: bitwise; the restored run's
    int8-variant launches exact."""
    import numpy as np
    from deepspeed_tpu_torch.memory import GlobalPrefixStore
    what = "kv tier (a) host, int8 KV"
    gated = tuple(range(len(prompts)))
    s8 = kv_scheduler(eng, kv_cache_dtype="int8",
                      prefix_store=GlobalPrefixStore(capacity_bytes=KV_HOST_MB << 20))
    tier = s8.kv_tier
    cold_t, cold_l, _, _ = kv_serve(s8, prompts, gated)
    C = s8.prefill_chunk
    thrash = [np.arange(2 * C, dtype=np.int32) * (i + 3) % eng.model_config.vocab_size
              for i in range(8)]
    kv_serve(s8, thrash, max_new=4)
    s8.radix.check_invariants()
    r0 = tier.restores
    s8.forwards.clear()
    reset_counts()
    rest_t, rest_l, _, _ = kv_serve(s8, prompts, gated)
    torch.cuda.synchronize()
    check_serve_counts(s8, read_counts(), f"{what} restores", int8_kv=True)
    check(tier.restores - r0 == len(prompts), f"{what}: {tier.restores - r0} restores of {len(prompts)}")
    h0 = s8.radix.hits
    hit_t, hit_l, _, _ = kv_serve(s8, prompts, gated)
    check(s8.radix.hits - h0 == len(prompts), f"{what}: {s8.radix.hits - h0} device hits")
    s8.radix.check_invariants()
    del s8
    off = kv_scheduler(eng, kv_cache_dtype="int8")
    off_t, off_l, _, _ = kv_serve(off, prompts, gated)
    del off
    torch.cuda.empty_cache()
    three_way([("restored", rest_t), ("device hit", hit_t), ("cold with the tier", cold_t),
               ("cold, tier off", off_t)],
              [("restored", rest_l), ("device hit", hit_l), ("cold with the tier", cold_l),
               ("cold, tier off", off_l)], f"{what}, {len(prompts)} requests (greedy and sampled)")


def kv_nvme_leg(torch, card, eng, ref):
    """(b) Leg (a) again over a store of 256 MB of host RAM spilling to NVMe
    under a temporary directory: both passes bitwise (a)'s; spills, NVMe
    bytes each way, the O_DIRECT share, restores whose submit-time
    look-ahead read was issued, and the TTFT p50 of the revisits restored
    from NVMe."""
    import shutil
    import tempfile
    root = os.environ.get(NVME_ENV) or tempfile.gettempdir()
    path = tempfile.mkdtemp(prefix="chip_smoke_kv_", dir=root)
    try:
        loaded = []
        from deepspeed_tpu_torch.memory import prefix_store
        load = prefix_store.GlobalPrefixStore._load

        def tracked(self, entry):  # which revisits came from disk
            loaded.append(entry.key)
            return load(self, entry)

        prefix_store.GlobalPrefixStore._load = tracked
        try:
            res = kv_host_leg(torch, card, eng,
                              {"capacity_bytes": KV_NVME_HOST_MB << 20, "nvme_path": path}, ref)
        finally:
            prefix_store.GlobalPrefixStore._load = load
        store = res["sched"].kv_tier.store
        st, io = store.stats(), store.io_stats()
        from_disk = {tuple(int(t) for t in k) for k in loaded}
        idx = [i for i, p in enumerate(res["p1"]) if tuple(int(t) for t in p) in from_disk]
        ttft = [res["ttft2"][i] for i in idx]
        direct = io["direct_read"] + io["direct_write"]
        moved = direct + io["buffered_read"] + io["buffered_write"]
        log(f"kv tier (b) NVMe under {path}: host budget {KV_NVME_HOST_MB} MiB, spills {st['spills']}, "
            f"NVMe loads {st['nvme_loads']} (revisits {idx}); written {io['nvme_bytes_written'] / 2**20:.1f} "
            f"MiB, read {io['nvme_bytes_read'] / 2**20:.1f} MiB; O_DIRECT {direct / max(moved, 1):.4f} of "
            f"{moved / 2**20:.1f} MiB; restores whose look-ahead read was issued at submit "
            f"{io['prefetches_landed']} of {st['nvme_loads']}; TTFT p50 of the revisits restored from "
            f"NVMe {_pct(ttft, 50) if ttft else float('nan'):.1f} ms, of all revisits "
            f"{_pct(res['ttft2'], 50):.1f} ms; {card}")
        check(st["spills"] > 0 and st["nvme_loads"] > 0, "kv tier (b): nothing went through NVMe")
        del res
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(path, ignore_errors=True)


def kv_extent_leg(torch, card, eng):
    """(c) Lossless extent paging on the llama3-8b engine (full width, 2
    layers): the long-context phase's pool (16 slots x 1024, chains of 8,
    chunk 64, K=4) with a host store; a request chained to 7968 tokens
    (7936 prompt + 32 new, 8 extents) has its cold extents demoted
    mid-decode (``demote_cold_extents(keep_recent=1)``),
    and the paging pump restores them: the stream and logits bitwise the
    same request without demotion, nothing left parked, exact launch
    counts; each extent's demote and restore time."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    from deepspeed_tpu_torch.memory import GlobalPrefixStore
    what = "kv tier (c) extent paging"
    S = LONG_MAX_LEN
    prompt = np.random.default_rng(SEED + 23).integers(
        0, eng.model_config.vocab_size, LONG_EXTENTS * S - S // 4).astype(np.int32)

    def make(store=None):
        return DecodeScheduler(eng, num_slots=LONG_SLOTS, max_len=S, max_extents=LONG_EXTENTS,
                               prefill_chunk=64, steps_per_sync=4, prefix_store=store)

    ref = make()
    h = ref.submit(prompt, max_new_tokens=LONG_NEW, collect_logits=True)
    ref_tok, ref_lg = h.result(), h.result_logits()
    del ref
    torch.cuda.empty_cache()
    s = make(GlobalPrefixStore(capacity_bytes=1 << 30))
    tier = s.kv_tier
    tier.warmup()
    tier.executor.time_transfers = True
    times = {"demote": [], "restore": []}
    for name in ("demote", "restore"):
        fn = getattr(tier, name + "_extent")

        def timed(*a, fn=fn, out=times[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return r

        setattr(tier, name + "_extent", timed)
    s.forwards.clear()
    s.ext_forwards.clear()
    reset_counts()
    h = s.submit(prompt, max_new_tokens=LONG_NEW, collect_logits=True)
    while s._prefill is not None or not s.active:
        s.step()
    slot = next(iter(s.active))
    s.step()  # one decode sync: mid-decode
    n = s.demote_cold_extents(slot, keep_recent=1)
    parked = slot in s._parked
    missing = s.cache.missing_extents(slot)
    tok, lg = h.result(), h.result_logits()
    torch.cuda.synchronize()
    counts = read_counts()
    check_long_counts(s, counts, what)
    same = np.array_equal(tok, ref_tok) and np.array_equal(lg, ref_lg)
    nd, dms, dgb = transfer_rates(torch, tier, "d2h")
    nh, hms, hgb = transfer_rates(torch, tier, "h2d")
    log(f"{what}: prompt {len(prompt)} + {LONG_NEW} new on a chain of "
        f"{s.cache.extents_needed(len(prompt) + LONG_NEW)} x {S}; demoted extents {missing} mid-decode "
        f"(parked {parked}); longctx demotes {s.longctx_demotes}, restores {s.longctx_restores}; stream and "
        f"logits bitwise the run without demotion: {same}; an extent ({S * s.cache.bytes_per_token() / 2**20:.1f} "
        f"MiB) demoted in {[round(t, 3) for t in times['demote']]} ms, restored in "
        f"{[round(t, 3) for t in times['restore']]} ms (host clock, synchronized); copies: D2H {dms:.3f} ms "
        f"= {dgb:.2f} GB/s ({nd}), H2D {hms:.3f} ms = {hgb:.2f} GB/s ({nh}), CUDA events; {card}")
    check(n >= 1 and parked and missing, f"{what}: nothing was demoted ({n})")
    check(same, f"{what}: the stream differs from the run without demotion")
    check(s.longctx_demotes >= 1 and s.longctx_restores >= 1, f"{what}: paging counters")
    check(not s._parked and not s._ext_parked, f"{what}: rows or entries left parked")
    check(tier.store.stats()["entries"] == 0, f"{what}: extent pages left in the store")
    del s
    torch.cuda.empty_cache()


def kv_tier_phase(torch, card, params=None, paging=True):
    """The hierarchical KV tier on the card (``python3 chip_smoke.py
    --kv-tier`` runs it alone): gpt2-large int8 at full width and depth
    (``params``: the fused engine's weights, else a random init from seed 0),
    the serving phase's configuration with ``hierarchical_kv`` at 4096 MB of
    host RAM and telemetry on: (a) the host tier (``kv_host_leg``) and the
    int8-KV gate (``kv_int8_gate``), (b) the NVMe tier (``kv_nvme_leg``);
    then, with ``paging``, (c) lossless extent paging (``kv_extent_leg``) on
    a llama3-8b engine built here at 2 layers (the full run runs (c) on the
    long-context phase's engine instead)."""
    import shutil
    import tempfile
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.telemetry import set_sink
    tel_dir = tempfile.mkdtemp(prefix="kv_tier_telemetry_")
    cb = {**SERVE_CONFIG["continuous_batching"],
          "hierarchical_kv": {"enabled": True, "host_capacity_mb": KV_HOST_MB}}
    config = {**SERVE_CONFIG, "continuous_batching": cb,
              "telemetry": {"enabled": True, "output_path": tel_dir, "flush_interval": 10**9,
                            "capacity_sample_every": 10**9}}
    try:
        set_sink(None)
        t0 = time.perf_counter()
        eng = deepspeed_tpu_torch.init_inference("gpt2-large", config=config, params=params)
        log(f"kv tier: gpt2-large int8 engine built in {time.perf_counter() - t0:.1f} s "
            f"({'the fused engine weights' if params is not None else 'random weights, seed 0'})")
        ref = timed_phase("kv tier: (a) host", kv_host_leg, torch, card, eng)
        gated = [ref["p2"][i] for i in ref["gated"]]
        del ref["sched"]
        eng._scheduler = None
        torch.cuda.empty_cache()
        timed_phase("kv tier: (a) int8 KV gate", kv_int8_gate, torch, eng, gated)
        timed_phase("kv tier: (b) NVMe", kv_nvme_leg, torch, card, eng, ref)
        eng.telemetry.close()  # before its directory goes
        del eng, ref
        torch.cuda.empty_cache()
        set_sink(None)
    finally:
        shutil.rmtree(tel_dir, ignore_errors=True)
    if paging:
        from deepspeed_tpu_torch.models import get_model
        llama = deepspeed_tpu_torch.init_inference(
            get_model("llama3-8b", num_layers=2),
            config={"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512})
        timed_phase("kv tier: (c) extent paging", kv_extent_leg, torch, card, llama)


def llama_serving_phase(torch, eng):
    """llama3-8b (full width, 2 layers) through the scheduler: 4 slots, 8
    requests (GQA g=4, D=128 and RoPE through the span and decode modes),
    exact launch counts and the kernel-vs-plain step check."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    sched = DecodeScheduler(eng, num_slots=4, steps_per_sync=4)
    check(sched._fused_block, f"llama3-8b serving: fused gate closed ({sched._fused_block_reasons})")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, eng.model_config.vocab_size, int(k)).astype(np.int32)
               for k in rng.integers(8, 192, 8)]
    reset_counts()
    outs, _, wall, _, ttft = serve(sched, prompts, max_new=32)
    torch.cuda.synchronize()
    check_serve_counts(sched, read_counts(), "llama3-8b serving")
    check_streams(outs, 32, eng.model_config.vocab_size, "llama3-8b serving")
    log(f"llama3-8b serving (2 of 32 layers, 4 slots, 8 requests, 32 new): {sum(map(len, outs))} tokens "
        f"in {wall:.3f} s; shapes {dict(sched.dispatched)}")
    sched.radix.check_invariants()
    step_logits_check(torch, eng, sched, "llama3-8b serving")
    del sched
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5b: long-context serving (extent chains) on the llama3-8b engine


# the pool: 16 slots of 1024 rows, chains of up to 8 extents (the 8192
# horizon), bench.py's chunk 64 and K=4 (bench.py:577's long-context bench
# serves one request at a time at contexts 1024..8192)
LONG_SLOTS, LONG_MAX_LEN, LONG_EXTENTS, LONG_NEW = 16, 1024, 8, 32


def _per_projection(sched):
    """Every dispatch of ``sched`` through the per-projection path: a
    dispatch with a live chain runs per projection (the fused decode-layer
    kernels walk no extents), so a reference that a chained stream is held
    to bitwise must run per projection too."""
    sched._fused_block = False
    return sched


def timed_requests(sched, prompts, max_new, collect=False, **kw):
    """Submit every prompt at t = 0, pump until all finish. Returns
    (streams, logits or None, wall s, TTFT ms, mean ITL ms) per request:
    TTFT from submit to the first token, ITL over the later tokens (the
    host sees a sync's K tokens at once, so ITL is per token over syncs)."""
    stamps = [[] for _ in prompts]
    hs = [sched.submit(p, max_new_tokens=max_new, collect_logits=collect,
                       on_token=lambda tok, done, st=st: st.append(time.perf_counter()), **kw)
          for p, st in zip(prompts, stamps)]
    t0 = time.perf_counter()
    while any(not h.done for h in hs):
        sched.step()
    wall = time.perf_counter() - t0
    ttft = [(st[0] - h._req.submit_ts) * 1e3 for h, st in zip(hs, stamps)]
    itl = [(st[-1] - st[0]) * 1e3 / max(1, len(st) - 1) for st in stamps]
    logits = [h.result_logits() for h in hs] if collect else None
    return [h.result() for h in hs], logits, wall, ttft, itl


def log_peak(torch, what):
    """The peak device memory since the last reset of the peak (the caching
    allocator's, which holds the KV pool, the weights and every transient
    such as the decode kernel's workspace), beside what is held now."""
    log(f"{what}: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held after (torch.cuda.max_memory_allocated)")


def check_long_counts(sched, counts, what, int8_kv=False):
    """Launches over a long-context stream: a forward that carried extent
    operands ran every projection through quant_matmul (fused qkv, o, gate,
    up, down: 5 a layer, and the head) and the extent modes once a layer;
    any other forward, with the fused gate open, kernels A and C once a layer,
    the paged modes once a layer and the head; nothing else."""
    cfg = sched.engine.model_config
    L = cfg.num_layers
    per_forward = (5 if cfg.activation in ("swiglu", "geglu") else 4) * L + 1
    n1, nc = sched.forwards[1], sum(v for c, v in sched.forwards.items() if c != 1)
    e1, ec = sched.ext_forwards[1], sum(v for c, v in sched.ext_forwards.items() if c != 1)
    u1, uc = n1 - e1, nc - ec
    sfx = "_int8" if int8_kv else ""
    fused = sched._fused_block
    want = {**ZERO_COUNTS,
            "quant_matmul": per_forward * (e1 + ec) + (1 if fused else per_forward) * (u1 + uc),
            "fused_qkv_ln": L * (u1 + uc) if fused else 0,
            "fused_out_mlp": L * (u1 + uc) if fused else 0,
            "paged_decode_attention" + sfx: L * u1, "paged_span_attention" + sfx: L * uc,
            "extent_paged_decode" + sfx: L * e1, "extent_paged_span" + sfx: L * ec}
    log(f"{what} launches {counts}, expected {want} (forwards {dict(sched.forwards)}, with extent "
        f"operands {dict(sched.ext_forwards)}, {L} layers, fused gate {'open' if fused else 'off'})")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    check(e1 > 0 and ec > 0, f"{what}: an extent width was never dispatched ({dict(sched.ext_forwards)})")


def one_sync_profile(torch, sched, what):
    """Device time by kernel and busy share over one sync (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, busy_ms = device_profile(prof, 1)
    if not rows:
        log(f"profile of {what}: the profiler recorded no device time (busy share not measured)")
        return sched.last_shape
    log(f"profile of {what} {sched.last_shape}: wall {wall_ms:.3f} ms under the profiler, device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  device {ms:9.4f} ms/sync {n:5d} calls/sync  {key[:80]}")
    return sched.last_shape


def lossy_step_check(torch, eng, sched, what):
    """One decode-width forward of the live lossy row through the kernels
    and through their plain versions on the card (two copies of the pool,
    the dispatch's extent operands with dropped extents inside the window's
    hole): relative L2 of the live row's logits within 5e-2."""
    live = sorted(sched.active.items())
    eo = sched._ext_operands(live)
    N = sched.cache.num_slots
    dev = eng.device
    widx = torch.zeros(N, dtype=torch.long, device=dev)
    spans = torch.zeros(N, dtype=torch.long, device=dev)
    ids = torch.zeros((N, 1), dtype=torch.long, device=dev)
    for slot, req in live:
        widx[slot] = int(sched.cache.lengths[slot])
        spans[slot] = 1
        ids[slot, 0] = req.out[-1]
    out = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            pool = tuple(tuple(t.clone() for t in comp) for comp in sched.cache.pool)
            out[impl] = eng.module.apply_with_cache(eng.net, ids, pool, 0, position_ids=widx[:, None],
                                                    write_index=widx, q_spans=spans, ext_ops=eo,
                                                    impl=impl)[0].float()
            del pool
    rows = [slot for slot, _ in live]
    lk, lp = out["kernel"][rows, 0], out["plain"][rows, 0]
    check(bool(torch.isfinite(lk).all()), f"{what}: non-finite step logits")
    rel = float((lk - lp).norm() / lp.norm())
    log(f"{what}: one decode step through the kernels vs plain on the card (dropped extents "
        f"{sched.cache.missing_extents(rows[0])}): rel L2 {rel:.3e}")
    check(rel <= 5e-2, f"{what}: step logits differ from plain by rel L2 {rel:.3e} > 5e-2")


def long_context_phase(torch, eng, max_len=LONG_MAX_LEN):
    """Long-context serving on the llama3-8b engine (full width, 2 layers,
    int8, kernel injection) through ``DecodeScheduler(eng, num_slots=16,
    max_len=1024, max_extents=8, prefill_chunk=64, steps_per_sync=4)``: the
    context sweep (1024..8192, one request at a time, 32 new); a chained
    4096-context request against the same on one 4096-row slot, tokens and
    logits bitwise, greedy and sampled; a mixed stream (prompts 6000 and 3000
    and six of 8-191 tokens, queued at t = 0) with exact launch counts, and
    at K=4 and K=1 per projection with identical streams; the int8 KV leg;
    the lossy leg (kv_window (64, 1024), an 8000-token prompt); exact launch
    counts and the peak device memory of the mixed stream and both legs. Every length
    scales with ``max_len`` (a rehearsal at a small pool runs the same
    extent structure). Returns the mixed stream's and the int8 leg's counts."""
    import numpy as np
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    S = max_len
    u = lambda n: max(1, n * S // LONG_MAX_LEN)  # noqa: E731
    vocab = eng.model_config.vocab_size
    rng = np.random.default_rng(SEED + 5)

    def rand_prompt(n):
        return rng.integers(0, vocab, int(n)).astype(np.int32)

    def make(**kw):
        return DecodeScheduler(eng, **{"num_slots": LONG_SLOTS, "max_len": S,
                                       "max_extents": LONG_EXTENTS, "prefill_chunk": 64,
                                       "steps_per_sync": 4, **kw})

    sched = make()
    check(sched.max_len == S and sched.cache.max_extents == LONG_EXTENTS,
          f"long context: pool {sched.max_len} x {sched.cache.max_extents}, expected {S} x {LONG_EXTENTS}")
    check(sched._fused_block, f"long context: fused gate closed ({sched._fused_block_reasons})")
    sched.submit(rand_prompt(u(1024) + 8), max_new_tokens=8).result()  # first-use costs, 2 extents

    # the context sweep (bench.py::_long_context_bench): one request at a
    # time; the 4096 request's greedy logits are the reference below
    for ctx in (S, 2 * S, 4 * S, 8 * S):
        p = rand_prompt(ctx - LONG_NEW)
        outs, lg, wall, ttft, itl = timed_requests(sched, [p], LONG_NEW, collect=ctx == 4 * S)
        if ctx == 4 * S:
            p4, chained_greedy = p, (outs[0], lg[0])
        check_streams(outs, LONG_NEW, vocab, f"long context {ctx}")
        n_ext = sched.cache.extents_needed(len(p) + LONG_NEW)
        log(f"llama3-8b long context {ctx} (prompt {len(p)} + {LONG_NEW} new, {n_ext} extent(s) of {S}): "
            f"TTFT {ttft[0]:.1f} ms, mean ITL {itl[0]:.3f} ms, {wall:.3f} s")
    sched.radix.check_invariants()
    check(not sched.cache.chain, "long context: a chain outlived its request")

    # a chained request is bitwise the same request on one big slot
    ref = _per_projection(make(max_len=4 * S, max_extents=1))
    kws = ({}, {"do_sample": True, "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 3})
    for kw in kws:
        if kw:
            got, gl, _, _, _ = timed_requests(sched, [p4], LONG_NEW, collect=True, **kw)
            got, gl = got[0], gl[0]
        else:
            got, gl = chained_greedy
        want, wl, _, _, _ = timed_requests(ref, [p4], LONG_NEW, collect=True, **kw)
        same = np.array_equal(got, want[0]) and np.array_equal(gl, wl[0])
        kind = "sampled" if kw else "greedy"
        log(f"llama3-8b chained {4 * S}-context request ({sched.cache.extents_needed(4 * S)} extents) vs "
            f"one {4 * S}-row slot, {kind}: tokens and logits bitwise equal {same}")
        check(same, f"long context: the chained request differs from one big slot ({kind})")
    chained_greedy = chained_greedy[1]
    del ref
    torch.cuda.empty_cache()

    # the mixed stream: two long requests and six short, queued at t = 0
    mixed = [rand_prompt(u(6000)), rand_prompt(u(3000))] + [
        rand_prompt(n) for n in np.random.default_rng(SEED).integers(8, 192, 6)]
    sched.forwards.clear()
    sched.ext_forwards.clear()
    sched.dispatched.clear()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    outs, _, wall, ttft, itl = timed_requests(sched, mixed, LONG_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    check_long_counts(sched, counts, "llama3-8b long-context mixed stream")
    log_peak(torch, "llama3-8b long-context mixed stream")
    check_streams(outs, LONG_NEW, vocab, "long-context mixed stream")
    check(not sched.cache.chain, "long context: a chain outlived the mixed stream")
    sched.radix.check_invariants()
    n_tok = sum(len(o) for o in outs)
    log(f"llama3-8b long-context mixed stream (prompts {[len(p) for p in mixed]}, {LONG_NEW} new, K=4, "
        f"fused gate open): {n_tok} tokens in {wall:.3f} s; TTFT ms {[round(t, 1) for t in ttft]}; "
        f"mean ITL ms {[round(t, 3) for t in itl]}; shapes {dict(sched.dispatched)}")
    per_proj = {}
    for k in (4, 1):
        s2 = _per_projection(make(steps_per_sync=k))
        per_proj[k], _, w2, _, _ = timed_requests(s2, mixed, LONG_NEW)
        check(not s2.cache.chain, "long context: a chain outlived the mixed stream")
        s2.radix.check_invariants()
        log(f"llama3-8b long-context mixed stream per projection at K={k}: {w2:.3f} s, shapes "
            f"{dict(s2.dispatched)}")
        del s2
        torch.cuda.empty_cache()
    same = [bool(np.array_equal(a, b)) for a, b in zip(per_proj[4], per_proj[1])]
    log(f"llama3-8b long-context mixed stream per projection, K=4 vs K=1: streams identical "
        f"{sum(same)}/{len(same)}")
    check(all(same), "long context: the mixed stream differs between K=4 and K=1")
    prefix = [next((i for i, (a, b) in enumerate(zip(f, q)) if a != b), len(f))
              for f, q in zip(outs, per_proj[4])]
    log(f"llama3-8b long-context mixed stream, fused gate open vs per projection at K=4: common prefix "
        f"per request {prefix} of {LONG_NEW} (fused and per-projection forwards round in other places)")

    # where a long stream's time goes: one chunk sync and one decode sync
    h = sched.submit(p4, max_new_tokens=LONG_NEW)
    sched.step()
    one_sync_profile(torch, sched, f"a {4 * S}-context chunk sync")
    while sched._prefill is not None:
        sched.step()
    one_sync_profile(torch, sched, f"a {4 * S}-context decode sync")
    h.result()
    del sched
    torch.cuda.empty_cache()

    # int8 KV: the chained 4096 request on an int8 pool against the bf16 pool
    q_s = make(kv_cache_dtype="int8")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    got, gl, _, _, _ = timed_requests(q_s, [p4], LONG_NEW, collect=True)
    torch.cuda.synchronize()
    int8_counts = read_counts()
    check_long_counts(q_s, int8_counts, "llama3-8b long-context int8 KV leg", int8_kv=True)
    log_peak(torch, "llama3-8b long-context int8 KV leg")
    r, g = chained_greedy, gl[0]
    same_tok = r.argmax(-1) == g.argmax(-1)
    n = len(same_tok) if same_tok.all() else int(np.argmin(same_tok)) + 1
    worst = float(np.abs(g[:n] - r[:n]).max()) / (0.05 * float(np.abs(r[:n]).max()) + 0.05)
    log(f"llama3-8b long-context int8 KV leg ({4 * S}-context request on an int8 pool): logit error / "
        f"bound {worst:.3f} over {n} steps (greedy flip {'none' if same_tok.all() else n - 1})")
    check(worst <= 1.0, "long context int8 KV: logit error beyond 0.05 * max|ref| + 0.05")
    del q_s
    torch.cuda.empty_cache()

    # lossy sliding window: an 8000-token prompt keeping a 64-token sink and
    # the last 1024 tokens, 64 new; the extents wholly in between drop
    lossy = make(allow_lossy_kv=True)
    window = (u(64), u(1024))
    n_prompt = LONG_EXTENTS * S - 192
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    h = lossy.submit(rand_prompt(n_prompt), max_new_tokens=64, kv_window=window)
    while lossy._prefill is not None or not lossy.active:
        lossy.step()
    slot = next(iter(lossy.active))
    lossy.step()  # the paging pump drops what slid out of the window
    dropped = lossy.cache.missing_extents(slot)
    held = sum(1 for x in lossy.cache.extents(slot) if x >= 0)
    log(f"llama3-8b lossy window {window} over {n_prompt} tokens: dropped extents {dropped}, demotes "
        f"{lossy.longctx_demotes}, the chain holds {held} of {len(lossy.cache.extents(slot))} pool rows, "
        f"free rows {lossy.cache.free_slots} of {LONG_SLOTS}")
    check(len(dropped) >= 5 or S != LONG_MAX_LEN, f"lossy window dropped only {dropped}")
    check(lossy.cache.free_slots == LONG_SLOTS - held, "lossy window: dropped rows not on the free list")
    lossy.cache.check_invariants()
    leg = read_counts()
    lossy_step_check(torch, eng, lossy, "llama3-8b lossy window")
    reset_counts()  # the step check's launches are not the leg's
    check(len(h.result()) == 64, "lossy window: short stream")
    leg = {k: v + read_counts()[k] for k, v in leg.items()}
    check_long_counts(lossy, leg, "llama3-8b lossy window leg")
    log_peak(torch, "llama3-8b lossy window leg")
    lossy.radix.check_invariants()
    check(not lossy.cache.chain and lossy.cache.free_slots + lossy.cache.cached_slots == LONG_SLOTS,
          "lossy window: rows not returned")
    del lossy
    torch.cuda.empty_cache()
    return counts, int8_counts


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


# ---------------------------------------------------------------------------
# phase 8a: mixtral-8x7b (MoE): comm on NCCL, int8 serving, bf16 training

MOE_MODEL, MOE_LAYERS = "mixtral-8x7b", 2
MOE_DEVICE = "cuda"  # the legs' device ("cpu" rehearses them on the host)
MOE_MODEL_KW = {}
MOE_B, MOE_P, MOE_NEW = 4, 128, 32
MOE_SLOTS, MOE_REQUESTS = 4, 8
MOE_SEQ, MOE_STEPS = 2048, 3
MOE_SERVE_CONFIG = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512,
                    "continuous_batching": {"enabled": True, "num_slots": MOE_SLOTS, "steps_per_sync": 4}}
# the first training step, kernels vs plain: loss and global grad norm
MOE_LOSS_REL, MOE_NORM_REL = 1e-3, 1e-2


def random_params(torch, model, dev, seed, int8):
    """Seeded random weights made on the card: float leaves normal(0.02)
    (norm scales ones, biases zeros), int8 leaves uniform in [-127, 127]
    with fp32 group scales around 2.7e-4 (a dequantized std near 0.02),
    the int8 tree's other float leaves in bf16 as ``quantize_params``
    leaves them. The host never holds the 46.7B-parameter-class tree."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, (shape, dt) in model.param_shapes().items():
        leaf = k.rsplit(".", 1)[-1]
        if dt == torch.int8:
            out[k] = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            continue
        if int8 and leaf.endswith("_scale"):
            out[k] = torch.rand(shape, generator=gen, device=dev) * 1e-4 + 2.2e-4
            continue
        if leaf == "scale":
            t = torch.ones(shape, device=dev)
        elif leaf.endswith("bias"):
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.empty(shape, device=dev).normal_(0.0, 0.02, generator=gen)
        out[k] = t.to(torch.bfloat16) if int8 else t
    return out


def moe_comm_leg(torch):
    """(a) ``comm`` on the card: an NCCL group of world 1 from
    ``init_distributed()`` (no arguments: the card's backend, an in-process
    store), ``initialize_mesh(expert=1)``; every collective on a CUDA
    tensor returns its input, one raw NCCL all-reduce and barrier run; the
    group is destroyed at the end."""
    import torch.distributed as tdist
    import deepspeed_tpu_torch.comm as dist
    dist.init_distributed(verbose=False)
    try:
        check(tdist.get_backend() == "nccl", f"comm: backend {tdist.get_backend()}, expected nccl")
        mesh = dist.initialize_mesh(expert=1)
        check(mesh.shape == {"pipe": 1, "expert": 1, "data": 1, "seq": 1, "tensor": 1},
              f"comm: mesh {mesh.shape}")
        x = torch.randn((4, 8), device="cuda")
        outs = {"all_reduce": dist.all_reduce(x), "all_reduce avg": dist.all_reduce(x, op="avg"),
                "all_gather": dist.all_gather(x, group=dist.DP_AXES),
                "reduce_scatter": dist.reduce_scatter(x, group="data"),
                "all_to_all_single": dist.all_to_all_single(x, group="expert", split_axis=0, concat_axis=1),
                "broadcast": dist.broadcast(x, group="data"), "reduce": dist.reduce(x),
                "all_reduce_autograd": dist.all_reduce_autograd(x, group=dist.DP_AXES)}
        for name, out in outs.items():
            check(torch.equal(out, x), f"comm: {name} at world 1 changed its input")
        y = x.clone()
        tdist.all_reduce(y)  # NCCL itself, on the default group
        dist.barrier()
        torch.cuda.synchronize()
        check(torch.equal(y, x), "comm: NCCL all_reduce at world 1 changed its input")
        check(dist.get_world_size() == 1 and dist.get_rank() == 0 and dist.get_rank("expert") == 0,
              "comm: world queries")
        log(f"comm: NCCL world of 1, mesh {mesh.shape}: {len(outs)} collectives and a raw NCCL "
            f"all_reduce return their input on cuda")
    finally:
        dist.destroy_process_group()
    check(not tdist.is_initialized(), "comm: the process group outlived the phase")


def expected_moe_counts(cfg, new_tokens):
    """Launches of one MoE generate of ``new_tokens`` on the per-projection
    path: each forward runs the fused int8 qkv and o a layer and the int8
    head (the experts and the router are torch.matmul), the prefill flash
    once a layer, each decode step the decode kernel once a layer."""
    L, steps = cfg.num_layers, new_tokens - 1
    return {**ZERO_COUNTS, "quant_matmul": (2 * L + 1) * (1 + steps), "flash_attention": L,
            "decode_attention": L * steps}


# kernels vs plain on an MoE model: a token whose router logits sit near a
# top-k boundary may pick another expert when bf16 rounds elsewhere, and
# its logits then differ wholly, as do those of every later token of its
# row that attends to it. So the gate runs on a view of the same weights
# that routes every token to all experts (top-k = E: the combine weights
# are the softmax, continuous in the input; every kernel of the path runs
# as at top 2): relative L2 within MOE_REL, as the dense checks. The top-2
# engine's own comparison is logged (per-position rel L2, positions beyond
# MOE_REL: the flips and what they reach)
MOE_REL = 5e-2


def all_experts_view(eng):
    """The engine's module and weights with every token routed to all
    experts (``moe_top_k`` = ``num_experts``)."""
    import dataclasses
    import types
    cfg = dataclasses.replace(eng.model_config, moe_top_k=eng.model_config.num_experts)
    module = type(eng.module)(cfg)
    return types.SimpleNamespace(module=module, net=module.bind(eng.params), device=eng.device,
                                 model_config=cfg)


def moe_logits_gate(torch, lk, lp, what, where, gate):
    """Kernel (``lk``) against plain (``lp``) logits (..., V): logged per
    position; with ``gate``, the whole relative L2 within ``MOE_REL``."""
    lk, lp = lk.float().reshape(-1, lk.shape[-1]), lp.float().reshape(-1, lp.shape[-1])
    check(bool(torch.isfinite(lk).all()), f"{what}: non-finite kernel-path logits ({where})")
    row = (lk - lp).norm(dim=-1) / lp.norm(dim=-1)
    rel = float((lk - lp).norm() / lp.norm())
    far = int((row > MOE_REL).sum())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"{what} {where}, kernels vs plain on the card: rel L2 {rel:.3e}; per position median "
        f"{float(row.median()):.3e}, max {float(row.max()):.3e}, {far} of {row.numel()} beyond {MOE_REL:g}; "
        f"argmax agreement {agree:.3f}" + ("" if gate else " (top 2: reported)"))
    if gate:
        check(rel <= MOE_REL, f"{what} {where}: kernel-path logits differ from plain by rel L2 {rel:.3e}")


def moe_prefill_check(torch, view, prompts, what, gate):
    """Prefill logits of the kernel path against the plain versions on the
    card (:func:`moe_logits_gate`)."""
    B, P = prompts.shape
    ids = torch.as_tensor(prompts, device=view.device).long()
    with torch.inference_mode():
        lk, _ = view.module.apply_with_cache(view.net, ids, view.module.init_cache(B, 256, device=view.device), 0)
        lp, _ = view.module.apply_with_cache(view.net, ids, view.module.init_cache(B, 256, device=view.device), 0,
                                             impl="plain")
    moe_logits_gate(torch, lk, lp, what, "prefill logits", gate)


def moe_decode_check(torch, view, prompts, what, gate, steps=4):
    """Decode steps of the per-projection path with its kernels against the
    same steps with their plain versions on the card (one prefill, two
    copies of the cache, both fed the kernel path's greedy tokens), by
    :func:`moe_logits_gate` over the steps' logits."""
    B, P = prompts.shape
    dev, model = view.device, view.module
    ks, ps = [], []
    with torch.inference_mode():
        cache = model.init_cache(B, 256, device=dev)
        logits, cache = model.apply_with_cache(view.net, torch.as_tensor(prompts, device=dev).long(), cache, 0)
        plain = tuple(tuple(c.clone() for c in comp) for comp in cache)
        tok = logits[:, -1].float().argmax(-1)
        for t in range(steps):
            pos = torch.full((B, 1), P + t, dtype=torch.long, device=dev)
            lk, _ = model.apply_with_cache(view.net, tok[:, None], cache, P + t, position_ids=pos)
            lp, _ = model.apply_with_cache(view.net, tok[:, None], plain, P + t, position_ids=pos, impl="plain")
            ks.append(lk[:, 0].float())
            ps.append(lp[:, 0].float())
            tok = ks[-1].argmax(-1)
    moe_logits_gate(torch, torch.stack(ks), torch.stack(ps), what, f"{steps} decode steps", gate)


def moe_step_check(torch, view, what, gate):
    """One chunk-width slot-pool step (rows of 64, 1, 1 and 0 live columns
    over a prefix of 64 written by a first step) through ``apply_with_cache``
    with its kernels and with their plain versions on two copies of the
    pool: the live logits by :func:`moe_logits_gate`, and each layer's
    routed-token counts sum to top-k times the live columns on both
    paths."""
    dev, model, cfg = view.device, view.module, view.model_config
    N, C = MOE_SLOTS, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids0 = torch.randint(0, cfg.vocab_size, (N, C), generator=gen, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (N, C), generator=gen, device=dev)
    widx = torch.tensor([C, C, C, 0], device=dev)
    spans = torch.tensor([C, 1, 1, 0], device=dev)
    pos = widx[:, None] + torch.arange(C, device=dev)[None, :]
    out = {}
    with torch.inference_mode():
        pool = model.init_cache(N, 512, device=dev)
        zero = torch.zeros((N, ), dtype=torch.long, device=dev)
        model.apply_with_cache(view.net, ids0, pool, 0, position_ids=torch.arange(C, device=dev)[None].expand(N, C),
                               write_index=zero, q_spans=torch.full_like(zero, C))
        for impl in ("kernel", "plain"):
            copy = tuple(tuple(c.clone() for c in comp) for comp in pool)
            lg, _, counts = model.apply_with_cache(view.net, ids, copy, 0, position_ids=pos, write_index=widx,
                                                   q_spans=spans, impl=impl, expert_stats=True)
            out[impl] = (lg.float(), counts)
            live = int(spans.sum())
            check(all(int(c.sum()) == cfg.moe_top_k * live for c in counts),
                  f"{what}: routed counts {counts.tolist()} do not sum to top-{cfg.moe_top_k} x {live}")
    lk = torch.cat([out["kernel"][0][b, :int(spans[b])] for b in range(N) if spans[b] > 0])
    lp = torch.cat([out["plain"][0][b, :int(spans[b])] for b in range(N) if spans[b] > 0])
    log(f"{what} slot-pool step of width {C}: routed counts per layer {out['kernel'][1].tolist()} (kernel "
        f"path), {out['plain'][1].tolist()} (plain), each summing to top-{cfg.moe_top_k} x "
        f"{int(spans.sum())} live columns")
    moe_logits_gate(torch, lk, lp, what, f"slot-pool step of width {C}", gate)


def moe_step_split(torch, eng, prompts, what):
    """A steady decode step's device time (CUDA events, L2 flushed), split:
    one decode step of the whole model, each layer's MoE alone (the router,
    the 8 experts' dequantization and products, the combine), each layer's
    decode-attention kernel alone at the step's shape; the rest is the
    difference (projections, norms, the head)."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    B, P = prompts.shape
    dev, model, cfg = eng.device, eng.module, eng.model_config
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    with torch.inference_mode():
        cache = model.init_cache(B, 256, device=dev)
        logits, cache = model.apply_with_cache(eng.net, torch.as_tensor(prompts, device=dev).long(), cache, 0)
        tok = logits[:, -1].float().argmax(-1)[:, None]
        pos = torch.full((B, 1), P, dtype=torch.long, device=dev)
        step = cuda_ms(lambda: model.apply_with_cache(eng.net, tok, cache, P, position_ids=pos), flush)
        x = torch.randn((B, 1, cfg.hidden_size), device=dev).to(cfg.dtype)
        moe = cuda_ms(lambda: eng.net.layers[0].moe.serving(x), flush)
        q = torch.randn((B, cfg.num_heads, cfg.head_size), device=dev).to(cfg.dtype)
        starts = torch.zeros((B, ), dtype=torch.int32, device=dev)
        ends = torch.full((B, ), P + 1, dtype=torch.int32, device=dev)
        attn = cuda_ms(lambda: decode_attention(q, cache[0][0], cache[1][0], starts, ends,
                                                block_kv=cfg.decode_block_kv), flush)
    del flush
    L = cfg.num_layers
    rest = step - L * (moe + attn)
    log(f"{what} decode step (B={B}, position {P}, {L} layers) device time {step:.4f} ms: experts "
        f"{L * moe:.4f} ms ({L} x {moe:.4f}, {L * moe / step:.3f} of the step), decode attention "
        f"{L * attn:.4f} ms ({L} x {attn:.4f}), the rest {rest:.4f} ms (projections, norms, head)")
    exp_bytes = sum(t.numel() * t.element_size() for k, t in eng.params.items() if "moe.experts." in k) / L
    log(f"{what} experts a layer: {exp_bytes / 1e9:.3f} GB of int8 weights and scales read, "
        f"{3 * cfg.num_experts * cfg.hidden_size * cfg.ffn_size * 4 / 1e9:.3f} GB of bf16 written and "
        f"read again by the dequantization; {moe:.4f} ms against the int8 read's bound "
        f"{exp_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return step, moe, attn


def moe_serving_leg(torch, card):
    """(b) mixtral-8x7b int8 serving at full width, 2 of 32 layers, seeded
    random weights, the per-projection path (the fused gate refuses MoE)."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    from deepspeed_tpu_torch.models import get_model
    what = f"{MOE_MODEL} int8"
    dev = torch.device(MOE_DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(MOE_MODEL, num_layers=MOE_LAYERS, **MOE_MODEL_KW)
    int8_model = get_model(MOE_MODEL, num_layers=MOE_LAYERS, int8_weights=True, int8_fused_qkv=True,
                           **MOE_MODEL_KW)
    eng = deepspeed_tpu_torch.init_inference(model, config=MOE_SERVE_CONFIG, device=dev,
                                             params=random_params(torch, int8_model, dev, SEED, int8=True))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    reasons = eng._fused_decode_eligible().reasons
    log(f"{what} (full width, depth cut to {MOE_LAYERS} of 32 layers: host set-up and device memory) "
        f"engine built in {setup_s:.1f} s, {held / 2**30:.3f} GiB of weights on the card; "
        f"moe part of the ready line{eng._moe_desc()!r}; fused gate: {list(reasons)}")
    cfg = eng.model_config
    E = cfg.num_experts
    check(any(f"num_experts={E}: the fused per-layer decode kernel has no expert dispatch" in r for r in reasons),
          f"{what}: the fused gate did not refuse MoE ({reasons})")
    check(eng._moe_desc() == f" moe[{E}e top2] ep=1", f"{what}: ready line {eng._moe_desc()!r}")
    vocab = cfg.vocab_size
    prompts = np.random.default_rng(SEED + 3).integers(0, vocab, (MOE_B, MOE_P)).astype(np.int32)
    reset_counts()
    greedy = eng.generate(prompts, max_new_tokens=MOE_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_moe_counts(cfg, MOE_NEW)
    log(f"{what} greedy generate launches {counts}, expected {want}")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    check_tokens(greedy, MOE_B, MOE_NEW, vocab, f"{what} greedy")
    again = eng.generate(prompts, max_new_tokens=MOE_NEW)
    check(all(np.array_equal(a, b) for a, b in zip(greedy, again)), f"{what}: two greedy generates differ")
    kw = {"do_sample": True, "temperature": 0.8, "top_k": 50, "seed": 3}
    sampled = eng.generate(prompts, max_new_tokens=MOE_NEW, **kw)
    check_tokens(sampled, MOE_B, MOE_NEW, vocab, f"{what} sampled")
    check(all(np.array_equal(a, b) for a, b in zip(sampled, eng.generate(prompts, max_new_tokens=MOE_NEW, **kw))),
          f"{what}: two sampled generates with one seed differ")
    every = all_experts_view(eng)
    for view, tag, gate in ((every, f"{what}, all {E} experts a token", True), (eng, f"{what}, top 2", False)):
        moe_prefill_check(torch, view, prompts, tag, gate)
        moe_decode_check(torch, view, prompts, tag, gate)
        moe_step_check(torch, view, tag, gate)
    del every
    step_s = steady_step(torch, eng, prompts, what, card)
    moe_step_split(torch, eng, prompts, what)

    # the scheduler: 8 requests of 16-200 tokens, 32 new, in 4 slots
    rng = np.random.default_rng(SEED + 4)
    reqs = [rng.integers(0, vocab, int(k)).astype(np.int32) for k in rng.integers(16, 201, MOE_REQUESTS)]
    sched = DecodeScheduler(eng, num_slots=MOE_SLOTS, steps_per_sync=4)
    reset_counts()
    outs, _, wall, syncs, ttft = serve(sched, reqs, max_new=MOE_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.num_layers
    n1 = sched.forwards[1]
    nc = sum(v for c, v in sched.forwards.items() if c != 1)
    want = {**ZERO_COUNTS, "quant_matmul": (2 * L + 1) * (n1 + nc), "paged_decode_attention": L * n1,
            "paged_span_attention": L * nc}
    log(f"{what} stream launches {counts}, expected {want} ({n1} decode-width and {nc} chunk-width "
        f"forwards of {L} layers)")
    check(counts == want, f"{what} stream launch counts {counts} != {want}")
    check(n1 > 0 and nc > 0, f"{what}: a width was never dispatched ({dict(sched.forwards)})")
    check_streams(outs, MOE_NEW, vocab, f"{what} stream")
    tokens = sum(map(len, outs))
    sync_ms = sorted(s * 1e3 for _, s in syncs)
    log(f"{what} stream ({MOE_SLOTS} slots, {MOE_REQUESTS} requests of {[len(r) for r in reqs]} tokens, "
        f"{MOE_NEW} new): {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; TTFT p50/p95 "
        f"{_pct(ttft, 50):.1f} / {_pct(ttft, 95):.1f} ms; {len(syncs)} syncs, median "
        f"{statistics.median(sync_ms):.3f} ms; shapes {dict(sched.dispatched)}; static decode step "
        f"{step_s * 1e3:.3f} ms = {MOE_B / step_s:.1f} tokens/s")
    sched.radix.check_invariants()
    solo_diff = []
    for i, r in enumerate(reqs):
        solo = DecodeScheduler(eng, num_slots=MOE_SLOTS, steps_per_sync=4).submit(r, max_new_tokens=MOE_NEW)
        if not np.array_equal(solo.result(), outs[i]):
            solo_diff.append(i)
    check(not solo_diff, f"{what}: requests {solo_diff} differ from their solo runs")
    # generate()'s rows: the same prompts one at a time. Its prefill runs
    # the flash kernel (or the plain cached attention) and its decode the
    # decode kernel, the scheduler the span and paged decode kernels: bf16
    # rounds in other places, so a greedy choice between close logits may
    # flip and a stream part for good (the tolerance of the port's int8
    # tests against JAX): the common prefixes cover at least half of the
    # tokens and at least one request agrees in full
    gen_rows = [eng.generate([r], max_new_tokens=MOE_NEW)[0] for r in reqs]
    prefix = [next((j for j, (a, b) in enumerate(zip(g, o)) if a != b), len(g)) for g, o in zip(gen_rows, outs)]
    log(f"{what}: each stream bitwise its solo run ({MOE_REQUESTS} of {MOE_REQUESTS}); common prefix with "
        f"generate()'s row per request {prefix} of {MOE_NEW}")
    check(sum(prefix) >= MOE_REQUESTS * MOE_NEW / 2 and max(prefix) == MOE_NEW,
          f"{what}: streams part from generate()'s rows early: {prefix}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: peak device memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated, set-up "
        f"included), {held / 2**30:.3f} GiB of it the weights; set-up {setup_s:.1f} s; {card}")
    del sched, eng
    torch.cuda.empty_cache()
    return counts


def moe_training_leg(torch, card):
    """(c) mixtral-8x7b bf16 training at full width, 2 layers:
    ``initialize`` -> ``train_batch``, AdamW with fp32 masters and clip
    1.0, micro 1, seq 2048; the first step's loss and grad norm through the
    kernels against the plain path; 3 steps."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    what = f"{MOE_MODEL} train"
    dev = torch.device(MOE_DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(MOE_MODEL, num_layers=MOE_LAYERS, attention_impl="flash", **MOE_MODEL_KW)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=random_params(torch, model, dev, SEED, int8=False),
        config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1}, device=dev)
    torch.cuda.synchronize()
    log(f"{what} engine (full width, {MOE_LAYERS} of 32 layers: 18 B a parameter on the card) built in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in engine.master.values()):,} parameters")
    batch = {"input_ids": np.random.default_rng(SEED + 5).integers(0, model.cfg.vocab_size, (1, MOE_SEQ))}
    placed = {"input_ids": torch.as_tensor(batch["input_ids"], device=dev)}
    res = {}
    for impl in ("plain", "kernel"):
        loss, grads = engine._micro_loss_and_grads(engine.params, placed, 1.0, impl=impl)
        res[impl] = (float(loss), _global_norm(torch, grads))
        del grads
    (lp, n_p), (lk, nk) = res["plain"], res["kernel"]
    log(f"{what} one micro-step, kernels vs plain on the card: loss {lk:.6f} vs {lp:.6f} (rel "
        f"{abs(lk - lp) / abs(lp):.3e}, limit {MOE_LOSS_REL:g}), grad norm {nk:.6f} vs {n_p:.6f} (rel "
        f"{abs(nk - n_p) / n_p:.3e}, limit {MOE_NORM_REL:g})")
    check(np.isfinite([lk, nk, lp, n_p]).all(), f"{what}: non-finite loss or grad norm")
    check(abs(lk - lp) <= MOE_LOSS_REL * abs(lp), f"{what}: loss {lk} vs plain {lp}")
    check(abs(nk - n_p) <= MOE_NORM_REL * n_p, f"{what}: grad norm {nk} vs plain {n_p}")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for _ in range(MOE_STEPS):
        l_, s_ = timed_steps(torch, engine, batch, 1)
        losses += l_
        secs += s_
        norms.append(engine._last_metrics["grad_norm"])
    counts = read_counts()
    want = expected_train_counts(model.cfg, MOE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    moe = engine.module.last_moe
    log(f"{what}: losses {[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}, steps "
        f"{[round(x * 1e3, 1) for x in secs]} ms ({MOE_SEQ / min(secs[1:]):.1f} tokens/s at the fastest), "
        f"launches {counts}, expected {want}; aux loss {float(moe['aux_loss']):.5f} (summed over "
        f"{MOE_LAYERS} layers), drop fraction by layer {[round(float(d), 4) for d in moe['drop_frac']]}; "
        f"peak device memory {peak / 2**30:.3f} GiB over the steps; {card}")
    check(np.isfinite(losses).all() and np.isfinite(norms).all(), f"{what}: non-finite loss or norm")
    check(counts == want, f"{what} launch counts {counts} != {want}")
    del engine
    torch.cuda.empty_cache()
    return counts


def moe_phase(torch, card):
    """mixtral-8x7b: (a) comm on NCCL at world 1, (b) int8 serving, (c)
    bf16 training. Returns the serving stream's and the training steps'
    launch counts."""
    timed_phase("mixtral-8x7b: (a) comm", moe_comm_leg, torch)
    serve_counts = timed_phase("mixtral-8x7b: (b) int8 serving", moe_serving_leg, torch, card)
    train_counts = timed_phase("mixtral-8x7b: (c) bf16 training", moe_training_leg, torch, card)
    return serve_counts, train_counts


# ---------------------------------------------------------------------------
# phase 8d: ZeRO stages 0-3 on llama3-8b (NCCL world of 1)

ZERO_MODEL, ZERO_LAYERS, ZERO_SEQ, ZERO_GAS, ZERO_STEPS = "llama3-8b", 2, 2048, 2, 3
ZERO_LOSS_RTOL = 2e-4      # stage 3 against stage 0: the JAX test's bound (tests/unit/test_engine.py:58)
ZERO_MASTER_REL_L2 = 1e-3  # stage 3's masters against stage 0's, a tensor


def _zero_engine(torch, dev, stage, tel_dir):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model = get_model(ZERO_MODEL, num_layers=ZERO_LAYERS, attention_impl="flash")
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": ZERO_GAS,
              "zero_optimization": {"stage": stage},
              "telemetry": {"enabled": True, "output_path": tel_dir}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=random_params(torch, model, dev, SEED, int8=False), config=config,
        device=dev)
    return engine


def _master_copy(engine):
    """The master's tensors cloned on the card (the comparisons run there;
    each run's peak is taken above what these copies hold)."""
    return {k: v.detach().clone() for k, v in engine.master.items()}


def zero_stage_run(torch, dev, stage, batch, tel_dir, save_dir=None):
    """``ZERO_STEPS`` steps at ``stage`` on fresh seeded weights; with
    ``save_dir`` a checkpoint after step ``ZERO_STEPS - 1`` (the master then
    is kept too). Returns the losses, step ms, peak GiB, launches, block
    gathers, the comm gauges and the final master."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # the earlier runs' kept masters
    t0 = time.perf_counter()
    engine = _zero_engine(torch, dev, stage, tel_dir)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    out = {"losses": [], "ms": [], "comm": [], "built_s": built}
    g = engine._stage3.gatherer if engine._stage3 is not None else None
    before = dict(g.counts) if g is not None else None
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for step in range(ZERO_STEPS):
        if save_dir is not None and step == ZERO_STEPS - 1:
            t = time.perf_counter()
            engine.save_checkpoint(save_dir, tag="zero")
            out["save_s"] = time.perf_counter() - t
            out["saved_master"] = _master_copy(engine)
            held += sum(t.numel() * t.element_size() for t in out["saved_master"].values())  # not the engine's
        losses, secs = timed_steps(torch, engine, batch, 1)
        out["losses"] += losses
        out["ms"] += [s * 1e3 for s in secs]
        out["comm"].append(dict(engine.last_comm_overlap["ops"]) if engine.last_comm_overlap else {})
        out.setdefault("efficiency", []).append(engine.last_comm_overlap["overlap_efficiency"]
                                                if engine.last_comm_overlap else None)
    out["counts"] = read_counts()
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    if g is not None:
        out["gathers"] = {k: g.counts[k] - before[k] for k in g.counts}
        out["predicted"] = engine._stage3.predicted_gathers()
    out["master"] = _master_copy(engine)
    engine.telemetry.close()
    del engine, g
    torch.cuda.empty_cache()
    # nothing outlives the engine (a reference cycle would keep its 16.6 GiB
    # of master and moments until a garbage collection)
    left = (torch.cuda.memory_allocated() - held) / 2**30 - sum(
        t.numel() * t.element_size() for t in out["master"].values()) / 2**30
    check(left < 1.0, f"zero stage {stage}: {left:.3f} GiB still held after the engine was dropped")
    return out


def _zero_resume(torch, dev, stage, batch, tel_dir, save_dir):
    """A fresh engine at ``stage`` loading the checkpoint: its loaded master,
    then one step's loss and master."""
    engine = _zero_engine(torch, dev, stage, tel_dir)
    t = time.perf_counter()
    engine.load_checkpoint(save_dir, tag="zero")
    load_s = time.perf_counter() - t
    loaded = _master_copy(engine)
    loss = float(engine.train_batch(batch=batch))
    master = _master_copy(engine)
    engine.telemetry.close()
    del engine
    torch.cuda.empty_cache()
    return {"loaded": loaded, "loss": loss, "master": master, "load_s": load_s}


def _zero_rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _bitwise(a, b):
    import torch
    return all(torch.equal(a[k], b[k]) for k in b)


def zero_phase(torch, card, dev):
    """(a) stages 0-3 on the same weights and batches, ``ZERO_STEPS``
    steps each: stages 1 and 2 bitwise stage 0, stage 3 within
    ``ZERO_LOSS_RTOL`` / ``ZERO_MASTER_REL_L2`` and bitwise its repeat;
    (b) exact block gathers and flash launches; (c) step ms, peak GiB and
    the comm gauges per stage; (d) a stage-3 checkpoint resumed at stage 3
    (bitwise the uninterrupted step) and at stage 0 (the master bitwise).
    Returns stage 3's launch counts."""
    import shutil
    import tempfile
    import numpy as np
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    cfg = get_model(ZERO_MODEL, num_layers=ZERO_LAYERS, attention_impl="flash").cfg
    batch = {"input_ids": np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, (ZERO_GAS, ZERO_SEQ))}
    dist.init_distributed(verbose=False, device=dev.type)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        log(f"zero: {ZERO_MODEL} at full width, {ZERO_LAYERS} of {32} layers, seq {ZERO_SEQ}, micro 1, gas "
            f"{ZERO_GAS}, bf16 compute, fp32 master AdamW, clip 1.0; an NCCL world of "
            f"{dist.get_world_size()} ({card}): every shard is whole, the stage-3 machinery runs")
        runs = {}
        for stage in (0, 1, 2, 3):
            runs[stage] = zero_stage_run(torch, dev, stage, batch, tmp,
                                         save_dir=os.path.join(tmp, "ckpt") if stage == 3 else None)
            if stage in (1, 2):  # (a) stage 0's arithmetic at world 1
                r = runs[stage]
                check(r["losses"] == runs[0]["losses"], f"zero stage {stage}: losses {r['losses']} "
                      f"!= stage 0's {runs[0]['losses']}")
                check(_bitwise(r.pop("master"), runs[0]["master"]),
                      f"zero stage {stage}: the master after {ZERO_STEPS} steps is not bitwise stage 0's")
        runs["3 again"] = zero_stage_run(torch, dev, 3, batch, tmp)
        want = expected_train_counts(cfg, ZERO_STEPS, gas=ZERO_GAS)
        base = runs[0]
        for stage, r in runs.items():
            ag = r["comm"][-1].get("all_gather", {})
            log(f"zero stage {stage}: losses {r['losses']}, steps {[round(x, 3) for x in r['ms']]} ms, peak "
                f"{r['peak_gib']:.3f} GiB, built in {r['built_s']:.1f} s; comm/overlap_efficiency "
                f"{r['efficiency']}, comm/all_gather/realized_ms "
                f"{ag.get('realized_s', 0.0) * 1e3:.3f}, comm/all_gather/dispatch_ms "
                f"{ag.get('dispatch_s', 0.0) * 1e3:.3f} (last step), ops "
                f"{sorted(r['comm'][-1])}; {card}")
            check(np.isfinite(r["losses"]).all(), f"zero stage {stage}: non-finite loss {r['losses']}")
            check(r["counts"] == want, f"zero stage {stage}: launch counts {r['counts']} != {want}")
        s3 = runs[3]
        rel = [abs(a - b) / abs(b) for a, b in zip(s3["losses"], base["losses"])]
        worst = max((_zero_rel_l2(torch, s3["master"][k], base["master"][k]), k) for k in base["master"])
        log(f"zero stage 3 vs 0: loss rel {[f'{x:.3e}' for x in rel]} (limit {ZERO_LOSS_RTOL:g}), worst master "
            f"rel L2 {worst[0]:.3e} ({worst[1]}; limit {ZERO_MASTER_REL_L2:g}), bitwise "
            f"{_bitwise(s3['master'], base['master'])}")
        check(max(rel) <= ZERO_LOSS_RTOL, f"zero stage 3: losses {s3['losses']} vs stage 0 {base['losses']}")
        check(worst[0] <= ZERO_MASTER_REL_L2, f"zero stage 3: master {worst[1]} rel L2 {worst[0]}")
        again = runs["3 again"]
        check(again["losses"] == s3["losses"] and _bitwise(again.pop("master"), s3["master"]),
              "zero stage 3: two runs (one saving a checkpoint) are not bitwise equal")
        del base["master"]
        # (b) block gathers: every block forward, each block with a saved
        # parameter (the layers and the head, not the embedding lookup) backward
        fwd, bwd = s3["predicted"]
        design = {"forward": (ZERO_LAYERS + 2) * ZERO_GAS * ZERO_STEPS,
                  "backward": (ZERO_LAYERS + 1) * ZERO_GAS * ZERO_STEPS}
        log(f"zero stage 3 block gathers over {ZERO_STEPS} steps: {s3['gathers']}, design {design} "
            f"(forward L + 2 = {fwd}, backward L + 1 = {bwd} a micro-step)")
        check(s3["gathers"] == design and (fwd, bwd) == (ZERO_LAYERS + 2, ZERO_LAYERS + 1),
              f"zero stage 3: block gathers {s3['gathers']} != {design}")
        # (d) checkpoints
        ck = os.path.join(tmp, "ckpt")
        nbytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ck) for f in fs)
        same = _zero_resume(torch, dev, 3, batch, tmp, ck)
        check(_bitwise(same.pop("loaded"), s3["saved_master"]), "zero: stage-3 resume did not load the saved master")
        check(same["loss"] == s3["losses"][-1] and _bitwise(same.pop("master"), s3.pop("master")),
              f"zero: the resumed stage-3 step ({same['loss']}) is not bitwise the uninterrupted one "
              f"({s3['losses'][-1]})")
        zero = _zero_resume(torch, dev, 0, batch, tmp, ck)
        check(_bitwise(zero.pop("loaded"), s3.pop("saved_master")),
              "zero: the stage-0 resume's master is not bitwise the stage-3 master gathered")
        log(f"zero checkpoint at stage 3: {nbytes / 2**30:.2f} GiB saved in {s3['save_s']:.1f} s; resumed at "
            f"stage 3 bitwise (loaded in {same['load_s']:.1f} s), at stage 0 the master bitwise (loaded in "
            f"{zero['load_s']:.1f} s, next loss {zero['loss']:.6f} vs stage 3's {same['loss']:.6f}); {card}")
        return s3["counts"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 8e: tensor parallelism 2, two ranks sharing the card over gloo

# llama3-8b at full width, 2 of 32 layers; NCCL refuses two ranks on one
# card, so the two ranks are two processes meeting through a file store in a
# gloo group whose collectives take the CUDA tensors (tp_gloo_check); the
# kernels run on the card in both. Step and sync times of two processes
# sharing one card are no tensor-parallel speed: logged, never claimed.
TP_MODEL, TP_LAYERS, TP_DEGREE = "llama3-8b", 2, 2
TP_B, TP_P, TP_NEW, TP_SLOTS, TP_REQUESTS = 4, 128, 32, 4, 8
TP_SEQ, TP_STEPS = 2048, 3
# the fused decode layer (kernels A and C) is off at tp > 1, as in the JAX
# engine; the tp 1 reference runs it off too, so both run per projection
TP_SERVE_CONFIG = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512, "fused_decode_block": False}
# bf16 training: the row-parallel products are summed over the ranks in
# bf16 after each rank's fp32 accumulation (tp 1 rounds once), so losses and
# grad norms are held within these of tp 1's, not bitwise
TP_LOSS_REL, TP_NORM_REL = 2e-3, 2e-2
TP_TIMEOUT_S = 600

def _tp_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def tp_gloo_check(torch, dev):
    """One call each of the collectives the tensor-parallel path runs, on
    ``dev`` tensors in the gloo group (all_gather, all_reduce SUM and MAX,
    broadcast): every result where the inputs say. A refused CUDA tensor
    raises here, before any phase leans on it."""
    import deepspeed_tpu_torch.comm as dist
    r, n = dist.get_rank(), dist.get_world_size()
    x = (torch.arange(8, device=dev) + r).to(torch.bfloat16)
    want = torch.cat([torch.arange(8, device=dev) + i for i in range(n)]).to(torch.bfloat16)
    check(torch.equal(dist.all_gather(x, group=dist.TENSOR_AXIS), want), "tp gloo all_gather")
    s = sum(torch.arange(8, device=dev) + i for i in range(n)).to(torch.bfloat16)
    check(torch.equal(dist.all_reduce(x, group=dist.TENSOR_AXIS), s), "tp gloo all_reduce SUM")
    check(torch.equal(dist.all_reduce(x.half(), dist.ReduceOp.MAX, dist.TENSOR_AXIS),
                      (torch.arange(8, device=dev) + n - 1).half()), "tp gloo all_reduce MAX")
    check(torch.equal(dist.broadcast(x, 0, dist.TENSOR_AXIS), torch.arange(8, device=dev).to(torch.bfloat16)),
          "tp gloo broadcast")
    return f"all_gather, all_reduce SUM/MAX, broadcast on {x.device.type} tensors: ok"


def _tp_whole_model(**kw):
    from deepspeed_tpu_torch.models import get_model
    return get_model(TP_MODEL, num_layers=TP_LAYERS, **kw)


def tp_int8_tree(torch, dev):
    """The whole int8 serving tree with split q/k/v, seeded, made on the
    card (the same bits on every rank: one generator, one device)."""
    import dataclasses
    model = _tp_whole_model()
    m8 = type(model)(dataclasses.replace(model.cfg, int8_weights=True, int8_fused_qkv=False,
                                         dtype=torch.bfloat16))
    return model, random_params(torch, m8, dev, SEED + 9, int8=True)


def fuse_qkv(torch, tree, layers):
    """The tp 1 engine's layout of ``tree``: each layer's q/k/v int8 columns
    and scales concatenated into ``qkv_q``/``qkv_scale`` (the same columns:
    quantization is per column)."""
    out = dict(tree)
    for i in range(layers):
        a = f"layers.{i}.attn."
        for leaf, fused in (("kernel_q", "qkv_q"), ("kernel_scale", "qkv_scale")):
            out[a + fused] = torch.cat([out.pop(f"{a}{p}_proj.{leaf}") for p in ("q", "k", "v")], dim=1)
    return out


def tp_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(SEED + 10)
    return (rng.integers(0, vocab, (TP_B, TP_P)).astype(np.int32),
            [rng.integers(0, vocab, int(k)).astype(np.int32) for k in rng.integers(8, 192, TP_REQUESTS)])


def tp_serve(torch, eng, dev):
    """generate() greedy and sampled (B 4, prompt 128, 32 new) with its
    launch counts, the prefill logits of the prompt batch, and the 4-slot
    stream of 8 requests with its logits, launch counts and forwards; every
    tensor on the host."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    vocab = eng.model_config.vocab_size
    prompts, stream = tp_prompts(vocab)
    out = {"desc": eng._tp_desc(), "fused_gate": bool(eng._fused_decode_eligible())}
    reset_counts()
    t = time.perf_counter()
    out["greedy"] = [r.tolist() for r in eng.generate(prompts, max_new_tokens=TP_NEW)]
    _tp_sync(torch, dev)
    out["generate_s"] = time.perf_counter() - t
    out["generate_counts"] = read_counts()
    out["sampled"] = [r.tolist() for r in eng.generate(prompts, max_new_tokens=TP_NEW, do_sample=True,
                                                      temperature=0.8, top_k=50, seed=SEED)]
    with torch.inference_mode():
        ids = torch.as_tensor(prompts, device=dev).long()
        out["prefill_logits"] = eng.module.apply_with_cache(eng.net, ids, eng._init_cache(TP_B, 256),
                                                           0)[0].cpu()
    sched = DecodeScheduler(eng, num_slots=TP_SLOTS, steps_per_sync=4, collect_logits=True)
    reset_counts()
    toks, logits, wall, _, ttft = serve(sched, stream, max_new=TP_NEW, collect=True)
    _tp_sync(torch, dev)
    out.update(stream=[r.tolist() for r in toks], stream_logits=logits, stream_s=wall,
               stream_counts=read_counts(), forwards=dict(sched.forwards))
    del sched
    # the int8 KV tier: the row scale's amax is a MAX over every rank's heads
    sched = DecodeScheduler(eng, num_slots=TP_SLOTS, steps_per_sync=4, collect_logits=True, kv_cache_dtype="int8")
    reset_counts()
    toks, logits, _, _, _ = serve(sched, stream[:TP_SLOTS], max_new=TP_NEW, collect=True)
    _tp_sync(torch, dev)
    out.update(int8_stream=[r.tolist() for r in toks], int8_stream_logits=logits, int8_counts=read_counts(),
               int8_forwards=dict(sched.forwards))
    del sched
    return out


def tp_expected(cfg, tp, serve):
    """Launches of ``tp_serve`` on one rank: every forward runs each layer's
    int8 projections (the fused qkv, o, gate, up, down at tp 1; q, k, v
    split at tp 2) and the int8 head; the prefill flash once a layer, a
    generate() decode step the decode kernel once a layer, a stream's
    width-1 forward the paged decode kernel and a chunk forward the span
    kernel once a layer (their int8-KV variants on the int8 pool); kernels
    A and C never (the fused decode layer is off). Returns (generate,
    stream, int8 stream)."""
    L = cfg.num_layers
    per_forward = (5 if tp == 1 else 7) * L + 1
    gen = {**ZERO_COUNTS, "quant_matmul": per_forward * TP_NEW, "flash_attention": L,
           "decode_attention": L * (TP_NEW - 1)}
    out = [gen]
    for fw, sfx in ((serve["forwards"], ""), (serve["int8_forwards"], "_int8")):
        n1 = fw.get(1, 0)
        nc = sum(v for c, v in fw.items() if c != 1)
        out.append({**ZERO_COUNTS, "quant_matmul": per_forward * (n1 + nc), "paged_decode_attention" + sfx: L * n1,
                    "paged_span_attention" + sfx: L * nc})
    return out


def tp_train(torch, dev, tp, stage, steps=TP_STEPS):
    """``steps`` bf16 steps (micro 1, seq ``TP_SEQ``, AdamW, clip 1.0) at
    ``stage`` on this rank's shard of the seeded weights made on the card:
    losses, grad norms, step ms, the peak memory and the flash launches."""
    import numpy as np
    import deepspeed_tpu_torch
    model = _tp_whole_model(attention_impl="flash")
    batch = {"input_ids": np.random.default_rng(SEED + 11).integers(0, model.cfg.vocab_size, (1, TP_SEQ))}
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "zero_optimization": {"stage": stage}, "mesh": {"tensor_parallel_size": tp} if tp > 1 else {}}
    params = random_params(torch, model, dev, SEED, int8=False)
    t = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config,
                                                     device=dev)
    del params
    built = time.perf_counter() - t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        _tp_sync(torch, dev)
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        _tp_sync(torch, dev)
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(engine._last_metrics["grad_norm"]))
    out = {"losses": losses, "norms": norms, "ms": ms, "built_s": built, "counts": read_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None,
           "local": (engine.module.cfg.local_heads, engine.module.cfg.local_kv_heads,
                     engine.module.cfg.local_ffn)}
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# faults planted in the copy-to-region backward (the gradient of a
# column-parallel product's input, summed over the ranks), one step each at
# stage 0: the first step's grad norm must leave ``TP_NORM_REL`` of tp 1's
TP_PLANTED = {"reduced twice": lambda orig, ctx, g: (2 * orig(ctx, g)[0], None),
              "not reduced": lambda orig, ctx, g: (g, None)}


def tp_planted(torch, dev, world):
    """The first step's grad norm under each of ``TP_PLANTED``, the
    operator restored after each."""
    from deepspeed_tpu_torch.comm import comm as comm_mod
    cls, out = comm_mod._CopyToRegion, {}
    saved, orig = cls.__dict__["backward"], cls.backward
    for name, fault in TP_PLANTED.items():
        cls.backward = staticmethod(lambda ctx, g, fault=fault: fault(orig, ctx, g))
        try:
            out[name] = tp_train(torch, dev, world, 0, steps=1)["norms"][0]
        finally:
            cls.backward = saved
    return out


def _tp_rank(rank, world, store, out_dir, dev):
    """One rank of the tp phase (a spawned process): the gloo group over the
    card, the mesh (tensor = world), then serving and training; results to
    ``out_dir/rank{rank}.pt``, a traceback to ``rank{rank}.err``."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import deepspeed_tpu_torch
        import deepspeed_tpu_torch.comm as dist
        dist.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                              verbose=False)
        dist.initialize_mesh(tensor=world)
        res = {"gloo": tp_gloo_check(torch, dev)}
        model, tree = tp_int8_tree(torch, dev)
        eng = deepspeed_tpu_torch.init_inference(model, config=TP_SERVE_CONFIG, params=tree, device=dev)
        del tree
        res["serve"] = tp_serve(torch, eng, dev)
        del eng
        res["train"] = {stage: tp_train(torch, dev, world, stage) for stage in (0, 3)}
        res["planted"] = tp_planted(torch, dev, world)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _tp_same(torch, a, b):
    """Bitwise equality of nested token lists and tensors."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tp_same(torch, x, y) for x, y in zip(a, b))
    import numpy as np
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a == b


def _tp_diff(torch, a, b):
    """The largest |a - b| over nested tensors (for the log of a mismatch)."""
    if isinstance(a, (list, tuple)):
        return max([_tp_diff(torch, x, y) for x, y in zip(a, b)] or [0.0])
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).abs().max()) if a.numel() else 0.0


def tp_phase(torch, card, dev):
    """(a) llama3-8b int8 serving at tp 1 (this process) and tp 2 (two
    ranks): generate() greedy and sampled, the prefill logits and a 4-slot
    stream's tokens and logits bitwise tp 1's on both ranks, exact launch
    counts per rank (kernels A and C at 0), the ready line's tensor part;
    (c) bf16 training at tp 1 (stage 0) and tp 2 (stages 0 and 3): losses
    and grad norms within ``TP_LOSS_REL`` / ``TP_NORM_REL`` of tp 1's and
    bitwise equal on the two ranks, exact flash launches, peak GiB a rank;
    each fault of ``TP_PLANTED`` leaves the grad-norm gate at the first
    step. (b), the kernels at the rank shapes, is in the kernel phase. Returns
    one rank's launch counts over the phase."""
    import dataclasses
    import shutil
    import tempfile
    import deepspeed_tpu_torch
    import torch.multiprocessing as mp
    log(f"tp: {TP_MODEL} at full width, {TP_LAYERS} of 32 layers; tp 1 in this process, tp {TP_DEGREE} as two "
        f"processes sharing the card over a gloo group ({card})")
    # (a) tp 1 serving: the engine's own layout (the fused qkv matmul), per projection
    t0 = time.perf_counter()
    model, tree = tp_int8_tree(torch, dev)
    eng = deepspeed_tpu_torch.init_inference(model, config=TP_SERVE_CONFIG,
                                             params=fuse_qkv(torch, tree, model.cfg.num_layers), device=dev)
    del tree
    check(not eng._fused_decode_eligible(), "tp 1 reference: the fused decode layer must be off")
    ref = tp_serve(torch, eng, dev)
    cfg = eng.model_config
    del eng
    for what, want in zip(("generate", "stream", "int8"), tp_expected(cfg, 1, ref)):
        check(ref[what + "_counts"] == want, f"tp 1 {what} launches {ref[what + '_counts']} != {want}")
    log(f"tp 1 serving: generate {ref['generate_s']:.3f} s, stream {ref['stream_s']:.3f} s "
        f"({sum(map(len, ref['stream']))} tokens), desc '{ref['desc']}', {time.perf_counter() - t0:.1f} s")
    # (c) tp 1 training, stage 0
    ref_train = tp_train(torch, dev, 1, 0)
    log(f"tp 1 training stage 0: losses {ref_train['losses']}, grad norms {ref_train['norms']}, step ms "
        f"{[round(x, 1) for x in ref_train['ms']]}, peak {ref_train['peak_gib']} GiB")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # tp 2: two ranks
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_tp_rank, args=(r, TP_DEGREE, store, tmp, dev)) for r in range(TP_DEGREE)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(TP_DEGREE)
                if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
        check(not alive, f"tp: {len(alive)} rank(s) still running after {TP_TIMEOUT_S} s; killed")
        check(not errs, "tp: a rank failed:\n" + "\n".join(errs))
        check(all(p.exitcode == 0 for p in procs), f"tp: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(TP_DEGREE)]
        log(f"tp {TP_DEGREE}: both ranks finished in {time.perf_counter() - t0:.1f} s (spawn, set-up, serving, "
            f"training; two processes sharing one card)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg2 = dataclasses.replace(cfg, int8_fused_qkv=False)
    for r, res in enumerate(ranks):
        s = res["serve"]
        log(f"tp rank {r}: gloo {res['gloo']}; desc '{s['desc']}'")
        check(s["desc"].startswith(f"tp={TP_DEGREE} (bitwise all-gather layout, kv_heads sharded /{TP_DEGREE}) "
                                   f"int8_fused_qkv=off (") and "component boundaries" in s["desc"],
              f"tp rank {r}: ready line '{s['desc']}'")
        check(not s["fused_gate"], f"tp rank {r}: the fused decode gate is open")
        for what, want in zip(("generate", "stream", "int8"), tp_expected(cfg2, TP_DEGREE, s)):
            got = {k: v for k, v in s[what + "_counts"].items() if v}
            log(f"tp rank {r} {what} launches {got} (every other kernel 0: "
                f"{got == {k: v for k, v in want.items() if v}})")
            check(s[what + "_counts"] == want, f"tp rank {r} {what} launches {s[what + '_counts']} != {want}")
        for key in ("greedy", "sampled", "prefill_logits", "stream", "stream_logits", "int8_stream",
                    "int8_stream_logits"):
            if not _tp_same(torch, s[key], ref[key]):
                check(False, f"tp rank {r} {key}: not bitwise tp 1's (max |diff| "
                      f"{_tp_diff(torch, s[key], ref[key]) if 'logits' in key else 'in the tokens'})")
            check(_tp_same(torch, s[key], ranks[0]["serve"][key]), f"tp rank {r} {key}: differs from rank 0")
        log(f"tp rank {r} serving: greedy, sampled, prefill logits {tuple(s['prefill_logits'].shape)}, "
            f"stream tokens and {sum(len(x) for x in s['stream_logits'])} step logits, the int8-KV stream's "
            f"{sum(len(x) for x in s['int8_stream_logits'])}, bitwise tp 1's; "
            f"generate {s['generate_s']:.3f} s, stream {s['stream_s']:.3f} s (two processes sharing one "
            f"card: not a tensor-parallel speed)")
        for stage, tr in res["train"].items():
            want = expected_train_counts(cfg, TP_STEPS)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tr["losses"], ref_train["losses"]))
            norm_rel = max(abs(a - b) / abs(b) for a, b in zip(tr["norms"], ref_train["norms"]))
            log(f"tp rank {r} training stage {stage}: losses {tr['losses']} (rel to tp 1 {loss_rel:.2e}, gate "
                f"{TP_LOSS_REL:g}), grad norms {tr['norms']} (rel {norm_rel:.2e}, gate {TP_NORM_REL:g}), "
                f"local heads/kv/ffn {tr['local']}, peak {tr['peak_gib']} GiB (tp 1: {ref_train['peak_gib']}), "
                f"step ms {[round(x, 1) for x in tr['ms']]} (two processes sharing one card), launches "
                f"{tr['counts']}")
            check(all(map(math.isfinite, tr["losses"] + tr["norms"])), f"tp rank {r} stage {stage}: non-finite")
            check(loss_rel <= TP_LOSS_REL, f"tp rank {r} stage {stage}: loss rel {loss_rel:.2e} > {TP_LOSS_REL:g}")
            check(norm_rel <= TP_NORM_REL, f"tp rank {r} stage {stage}: norm rel {norm_rel:.2e} > {TP_NORM_REL:g}")
            check(tr["losses"] == ranks[0]["train"][stage]["losses"], f"tp rank {r} stage {stage}: losses "
                  f"differ from rank 0's")
            check(tr["counts"] == want, f"tp rank {r} stage {stage}: launches {tr['counts']} != {want}")
        first = ref_train["norms"][0]
        for name, norm in res["planted"].items():
            rel = abs(norm - first) / first
            log(f"tp rank {r} planted fault (copy-to-region backward {name}): first grad norm {norm} vs tp 1 "
                f"{first} (rel {rel:.2e}; the sound stage 0 run "
                f"{abs(res['train'][0]['norms'][0] - first) / first:.2e}, gate {TP_NORM_REL:g})")
            check(rel > TP_NORM_REL, f"tp rank {r}: the planted fault '{name}' passed the grad-norm gate")
    s = ranks[0]["serve"]
    return {k: s["generate_counts"][k] + s["stream_counts"][k] + s["int8_counts"][k]
            + sum(t["counts"][k] for t in ranks[0]["train"].values()) for k in ZERO_COUNTS}


# ---------------------------------------------------------------------------
# phase 8f: pipeline parallelism 2, two ranks sharing the card over gloo

# gpt2-large at full width, 18 of its 36 layers (9 a stage: the depth cut so
# that the whole run stays inside its time limit), bench.py's
# training config with gas 4: M = 4 microbatches over S = 2 stages. pp 1 in
# this process, pp 2 as two processes meeting through a file store in a gloo
# group (NCCL refuses two ranks on one card); gloo's point-to-point ops take
# host tensors only, so ``comm.ppermute`` stages the activations and their
# gradients through host memory there (``pipe_gloo_check``). The kernels run
# on the card in both ranks. Step times of two processes sharing one card
# are no pipeline speed: logged, never claimed.
PIPE_MODEL, PIPE_LAYERS, PIPE_DEGREE, PIPE_GAS, PIPE_STEPS, PIPE_SEQ = "gpt2-large", 18, 2, 4, 2, 1024
PIPE_SCHEDULES = ("fill_drain", "1f1b")
# bf16: pp 2 sums a replicated tensor's gradient parts (the tied table's
# lookup on stage 0, its head on stage 1) in fp32 over pipe where pp 1 sums
# them in bf16 at the compute copy; losses and grad norms are held within
# these of pp 1's
PIPE_LOSS_REL, PIPE_NORM_REL = 2e-3, 2e-2
PIPE_TIMEOUT_S = 900


def pipe_gloo_check(torch, dev):
    """One exchange each way over ``pipe`` (``send_recv_next``,
    ``send_recv_prev``) and a partial ``ppermute`` on ``dev`` tensors, bf16
    and fp32: every result where the inputs say, on ``dev``, and the host
    staging of the gloo branch counted by the comms logger."""
    import deepspeed_tpu_torch.comm as dist
    r, n = dist.get_rank(dist.PIPE_AXIS), dist.get_world_size(dist.PIPE_AXIS)
    cl = dist.configure(enabled=True)
    base = torch.arange(8, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        x = (base + 10 * r).to(dt)
        for got, want, what in ((dist.send_recv_next(x), base + 10 * ((r - 1) % n), "send_recv_next"),
                                (dist.send_recv_prev(x), base + 10 * ((r + 1) % n), "send_recv_prev"),
                                (dist.ppermute(x, [(0, 1)]), base if r == 1 else 0 * base, "ppermute [(0, 1)]")):
            check(got.device == x.device and got.dtype == dt and torch.equal(got, want.to(dt)),
                  f"pipe gloo {what} {dt}: {got.tolist()}")
    staged = sum(c for sizes in cl.comms_dict.get("ppermute_host_staged", {}).values() for c in sizes.values())
    dist.configure(enabled=False)
    check(staged == 6, f"pipe gloo: {staged} host-staged exchanges logged, expected 6")
    return f"send_recv_next, send_recv_prev and a partial ppermute on {x.device.type} tensors, bf16 and fp32: " \
           f"ok, {staged} staged through host"


def _pipe_batches(vocab):
    import numpy as np
    B = TRAIN_CONFIG["train_micro_batch_size_per_gpu"] * PIPE_GAS
    return [{"input_ids": np.random.default_rng(SEED + 12 + i).integers(0, vocab, (B, PIPE_SEQ)).astype(np.int32)}
            for i in range(PIPE_STEPS)]


def _pipe_engine(torch, dev, pp, schedule=None, seed=SEED):
    """gpt2-large on seeded weights made on the card, bench.py's config at
    gas ``PIPE_GAS``; at ``pp`` > 1 under ``schedule`` (this rank keeps its
    stage's layers and the replicated tensors of the whole tree)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model = get_model(PIPE_MODEL, num_layers=PIPE_LAYERS, attention_impl="flash", remat_policy=None,
                      scan_layers=False)
    config = {**TRAIN_CONFIG, "gradient_accumulation_steps": PIPE_GAS}
    if pp > 1:
        config.update(mesh={"pipeline_parallel_size": pp}, pipeline={"schedule": schedule})
    params = random_params(torch, model, dev, seed, int8=False)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config, device=dev)
    del params
    torch.cuda.empty_cache()
    return engine


def _digests(torch, tensors):
    """{key: sha256 of the tensor's bytes} (a bitwise comparison across
    processes without shipping the tensors)."""
    import hashlib
    return {k: hashlib.sha256(v.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            for k, v in tensors.items()}


def pipe_train(torch, engine, batches, save=None):
    """A ``train_batch`` step on each of ``batches``: losses, grad norms,
    step ms, each step's schedule and in-flight count, the flash launches,
    the peak GiB; on a pipe stage the replicated tensors' digests after
    each step and the master's after the last; ``save``: (directory, i)
    saves a checkpoint before step i (its master's digests under
    ``saved``)."""
    out = {"losses": [], "norms": [], "ms": [], "pipe": [], "replicas": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    staged = engine._pp > 1
    for i, batch in enumerate(batches):
        if save is not None and i == save[1]:
            t = time.perf_counter()
            engine.save_checkpoint(save[0])
            out["save_s"] = time.perf_counter() - t
            out["saved"] = _digests(torch, engine.master)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out["losses"].append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
        out["pipe"].append(dict(getattr(engine, "last_pipe", {})))
        if staged:
            out["replicas"].append(_digests(torch, {k: v for k, v in engine.master.items()
                                                    if not engine._pipe_local[k]}))
    out["counts"] = read_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if staged:
        out["master"] = _digests(torch, engine.master)
    return out


# faults planted on every rank, one fill-drain step each: the first step's
# grad norm must leave ``PIPE_NORM_REL`` of pp 1's
PIPE_PLANTED = ("the replicated tensors' gradient sum over pipe left out",
                "microbatch 1's activation gradient dropped at the stage boundary")


def pipe_planted(torch, dev, world, batch):
    """The first step's grad norm under each fault of ``PIPE_PLANTED``, the
    code restored after each."""
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.schedule import PipeStage
    reduce, backward = DeepSpeedEngine._reduce, PipeStage.backward

    def no_pipe_sum(self, tensors, group, op):
        if group != dist.PIPE_AXIS:
            reduce(self, tensors, group, op)

    def drop_mb1(self, m, dy, side_seeds=None):
        dx = backward(self, m, dy, side_seeds)
        return torch.zeros_like(dx) if dx is not None and m == 1 else dx

    out = {}
    for name, cls, attr, fault in ((PIPE_PLANTED[0], DeepSpeedEngine, "_reduce", no_pipe_sum),
                                   (PIPE_PLANTED[1], PipeStage, "backward", drop_mb1)):
        saved = cls.__dict__[attr]
        setattr(cls, attr, fault)
        try:
            engine = _pipe_engine(torch, dev, world, "fill_drain")
            engine.train_batch(batch=batch)
            out[name] = float(engine._last_metrics["grad_norm"])
            del engine
            torch.cuda.empty_cache()
        finally:
            setattr(cls, attr, saved)
    return out


def _pipe_rank(rank, world, store, out_dir, dev):
    """One rank of the pipe phase (a spawned process): the gloo group over
    the card, the mesh (pipe = world), then each schedule's steps (the
    fill-drain run saves a checkpoint before its last step), a resume at pp
    2 from it, the planted faults; results to ``out_dir/rank{rank}.pt``, a
    traceback to ``rank{rank}.err``."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import deepspeed_tpu_torch.comm as dist
        dist.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                              verbose=False)
        dist.initialize_mesh(pipe=world)
        res = {"gloo": pipe_gloo_check(torch, dev), "stage": dist.get_rank(dist.PIPE_AXIS), "runs": {}}
        ck = os.path.join(out_dir, "ckpt")
        batches = None
        for schedule in PIPE_SCHEDULES:
            t = time.perf_counter()
            engine = _pipe_engine(torch, dev, world, schedule)
            built = time.perf_counter() - t
            batches = batches or _pipe_batches(engine.module.cfg.vocab_size)
            res["runs"][schedule] = pipe_train(torch, engine, batches,
                                               save=(ck, PIPE_STEPS - 1) if schedule == "fill_drain" else None)
            res["runs"][schedule]["built_s"] = built
            res["layers"] = list(engine._pipe_layers)
            del engine
            torch.cuda.empty_cache()
        # the checkpoint saved before the last fill-drain step, resumed at pp 2
        engine = _pipe_engine(torch, dev, world, "1f1b", seed=SEED + 1)
        t = time.perf_counter()
        engine.load_checkpoint(ck)
        load_s = time.perf_counter() - t
        res["runs"]["resumed"] = pipe_train(torch, engine, batches[PIPE_STEPS - 1:])
        res["runs"]["resumed"]["load_s"] = load_s
        del engine
        torch.cuda.empty_cache()
        res["planted"] = pipe_planted(torch, dev, world, batches[0])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def pipe_expected(layers, steps):
    """Launches of ``steps`` steps on a stage of ``layers`` layers: one flash
    forward, dQ and dK/dV a layer a microbatch (no remat policy), nothing
    else."""
    n = layers * PIPE_GAS * steps
    return {**ZERO_COUNTS, "flash_attention": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def pipe_phase(torch, card, dev):
    """gpt2-large at full width, ``PIPE_LAYERS`` layers, bf16, gas 4: pp 1 in this process against
    pp 2 as two ranks sharing the card (``_pipe_rank``): under fill-drain and
    1F1B, 3 steps on the same weights and batches, losses and grad norms
    within ``PIPE_LOSS_REL`` / ``PIPE_NORM_REL`` of pp 1's, 1F1B bitwise
    fill-drain (losses, norms, every master tensor), the replicated tensors
    bitwise across the ranks after each step, exact flash launches a rank
    a step; a checkpoint saved at pp 2 resumes at pp 2 (that step and the
    master bitwise) and loads at pp 1 here (the master bitwise); each fault
    of ``PIPE_PLANTED`` leaves the grad-norm gate at the first step. Peak
    GiB a rank (1F1B's at most fill-drain's) and step times (two processes
    sharing one card: no pipeline speed) are logged. Returns one rank's
    launch counts over the phase."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    log(f"pipe: {PIPE_MODEL} at full width, {PIPE_LAYERS} of 36 layers, bf16, micro {TRAIN_CONFIG['train_micro_batch_size_per_gpu']} "
        f"x gas {PIPE_GAS}, seq {PIPE_SEQ}; pp 1 in this process, pp {PIPE_DEGREE} as two processes sharing the "
        f"card over a gloo group ({card})")
    engine = _pipe_engine(torch, dev, 1)
    batches = _pipe_batches(engine.module.cfg.vocab_size)
    L = engine.module.cfg.num_layers
    ref = pipe_train(torch, engine, batches)
    del engine
    torch.cuda.empty_cache()
    check(ref["counts"] == pipe_expected(L, PIPE_STEPS), f"pp 1 launches {ref['counts']}")
    log(f"pp 1: losses {ref['losses']}, grad norms {ref['norms']}, step ms {[round(x, 1) for x in ref['ms']]}, "
        f"peak {ref['peak_gib']:.3f} GiB")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_pipe_rank, args=(r, PIPE_DEGREE, store, tmp, dev)) for r in range(PIPE_DEGREE)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + PIPE_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(PIPE_DEGREE)
                if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
        check(not alive, f"pipe: {len(alive)} rank(s) still running after {PIPE_TIMEOUT_S} s; killed")
        check(not errs, "pipe: a rank failed:\n" + "\n".join(errs))
        check(all(p.exitcode == 0 for p in procs), f"pipe: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(PIPE_DEGREE)]
        log(f"pp {PIPE_DEGREE}: both ranks finished in {time.perf_counter() - t0:.1f} s (spawn, two schedules, a "
            f"checkpoint round trip, two planted faults; two processes sharing one card)")
        # the pp 2 checkpoint loads at pp 1: the master bitwise what the ranks saved
        engine = _pipe_engine(torch, dev, 1, seed=SEED + 2)
        t = time.perf_counter()
        engine.load_checkpoint(os.path.join(tmp, "ckpt"))
        load_s = time.perf_counter() - t
        loaded = _digests(torch, engine.master)
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saved = {}
    for res in ranks:
        saved.update(res["runs"]["fill_drain"]["saved"])
    check(set(saved) == set(loaded) and saved == loaded, "pipe: the pp 2 checkpoint loaded at pp 1 is not bitwise "
          f"the ranks' master ({sum(saved.get(k) != v for k, v in loaded.items())} of {len(loaded)} tensors differ)")
    log(f"pp 2 checkpoint loaded at pp 1 in {load_s:.1f} s: all {len(loaded)} master tensors bitwise the two "
        f"ranks' at the save")
    for r, res in enumerate(ranks):
        runs, layers = res["runs"], res["layers"]
        log(f"pipe rank {r} (stage {res['stage']}, layers {layers[0]}-{layers[-1]}): gloo {res['gloo']}")
        check(res["stage"] == r and len(layers) == L // PIPE_DEGREE, f"pipe rank {r}: stage {res['stage']}, "
              f"{len(layers)} layers")
        for schedule in PIPE_SCHEDULES:
            tr = runs[schedule]
            loss_rel, norm_rel = _rel(tr["losses"], ref["losses"]), _rel(tr["norms"], ref["norms"])
            want = pipe_expected(len(layers), PIPE_STEPS)
            log(f"pipe rank {r} {schedule}: losses {tr['losses']} (rel to pp 1 {loss_rel:.2e}, gate "
                f"{PIPE_LOSS_REL:g}), grad norms {tr['norms']} (rel {norm_rel:.2e}, gate {PIPE_NORM_REL:g}), "
                f"in flight {[p.get('max_in_flight') for p in tr['pipe']]}, peak {tr['peak_gib']:.3f} GiB (pp 1: "
                f"{ref['peak_gib']:.3f}), step ms {[round(x, 1) for x in tr['ms']]} (two processes sharing one "
                f"card), built {tr['built_s']:.1f} s, launches {tr['counts']}")
            check(all(map(math.isfinite, tr["losses"] + tr["norms"])), f"pipe rank {r} {schedule}: non-finite")
            check(loss_rel <= PIPE_LOSS_REL, f"pipe rank {r} {schedule}: loss rel {loss_rel:.2e}")
            check(norm_rel <= PIPE_NORM_REL, f"pipe rank {r} {schedule}: norm rel {norm_rel:.2e}")
            check([p["schedule"] for p in tr["pipe"]] == [schedule] * PIPE_STEPS, f"pipe rank {r}: schedules "
                  f"{tr['pipe']}")
            check(tr["counts"] == want, f"pipe rank {r} {schedule}: launches {tr['counts']} != {want}")
            check(tr["losses"] == ranks[0]["runs"][schedule]["losses"], f"pipe rank {r} {schedule}: losses differ "
                  f"from rank 0's")
            for i, (mine, first) in enumerate(zip(tr["replicas"], ranks[0]["runs"][schedule]["replicas"])):
                check(mine and mine == first, f"pipe rank {r} {schedule} step {i + 1}: the replicated tensors are "
                      f"not bitwise rank 0's")
        fd, ob = runs["fill_drain"], runs["1f1b"]
        check(ob["losses"] == fd["losses"] and ob["norms"] == fd["norms"] and ob["master"] == fd["master"],
              f"pipe rank {r}: 1F1B is not bitwise fill-drain")
        check(ob["peak_gib"] <= fd["peak_gib"], f"pipe rank {r}: 1F1B peak {ob['peak_gib']:.3f} GiB above "
              f"fill-drain's {fd['peak_gib']:.3f}")
        rs = runs["resumed"]
        check(rs["losses"] == fd["losses"][-1:] and rs["norms"] == fd["norms"][-1:] and rs["master"] == fd["master"],
              f"pipe rank {r}: the resume at pp 2 is not bitwise the uninterrupted step ({rs['losses']} vs "
              f"{fd['losses'][-1:]})")
        check(rs["counts"] == pipe_expected(len(layers), 1), f"pipe rank {r} resumed: launches {rs['counts']}")
        log(f"pipe rank {r}: 1F1B bitwise fill-drain (losses, norms, {len(fd['master'])} master tensors), the "
            f"replicated tensors bitwise across the ranks after every step; checkpoint saved in "
            f"{fd.get('save_s', 0):.1f} s, resumed at pp 2 (load {rs['load_s']:.1f} s): step {PIPE_STEPS} and the "
            f"master bitwise")
        first = ref["norms"][0]
        for name, norm in res["planted"].items():
            rel = abs(norm - first) / first
            log(f"pipe rank {r} planted fault ({name}): first grad norm {norm} vs pp 1 {first} (rel {rel:.2e}; the "
                f"sound fill-drain run {abs(fd['norms'][0] - first) / first:.2e}, gate {PIPE_NORM_REL:g})")
            check(rel > PIPE_NORM_REL, f"pipe rank {r}: the planted fault '{name}' passed the grad-norm gate")
    runs = ranks[0]["runs"]
    return {k: sum(runs[s]["counts"][k] for s in PIPE_SCHEDULES + ("resumed", )) for k in ZERO_COUNTS}


# ---------------------------------------------------------------------------
# phase 8g: sequence parallelism 2, two ranks sharing the card over gloo

# llama3-8b at full width, 2 of 32 layers, bf16, AdamW, micro 1, seq 8192:
# sp 1 in this process, sp 2 as two processes meeting through a file store
# in a gloo group (NCCL refuses two ranks on one card). Both hold the whole
# model and optimizer state (seq ranks are replicas; there is no data axis
# to shard over); the all-to-alls and the ring's exchanges stage through
# host memory on gloo. Step times of two processes sharing one card are no
# sequence-parallel speed: logged, never claimed.
SEQ_DEGREE, SEQ_STEPS, SEQ_LEN = 2, 2, 8192  # the model: TP_MODEL at TP_LAYERS
SEQ_IMPLS = ("ulysses", "ring")
SEQ_TIMEOUT_S = 600
# bf16: sp 2 runs each projection on half the rows (other GEMM tilings) and
# sums the weight gradients' two halves in fp32 over seq; the ring merges
# its steps' partial softmaxes in fp32. Losses and grad norms are held
# within these of sp 1's, and each layer's attention weight gradients (the
# first micro-step, before any update) within SEQ_GRAD_REL relative L2: a
# planted fault of the sequence split must leave that gate
SEQ_LOSS_REL, SEQ_NORM_REL, SEQ_GRAD_REL = 2e-3, 2e-2, 5e-2
SEQ_PROBE_KEYS = tuple(f"layers.{i}.attn.{p}_proj.kernel" for i in range(TP_LAYERS) for p in "qkvo")
# the seq-parallel prefill: int8 weights at the serving defaults (the fused
# decode block serves the decode rows and base chunks; the wide chunks of
# seq_parallel_degree x prefill_chunk columns go per projection at sp 1 and
# sp 2 alike)
SEQ_SERVE_CONFIG = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 1024}
SEQ_SERVE_SCHED = {"num_slots": 4, "max_len": 1024, "prefill_chunk": 64, "steps_per_sync": 4,
                   "collect_logits": True, "seq_parallel_min_tokens": 256, "seq_parallel_degree": SEQ_DEGREE}
SEQ_SERVE_NEW = 16
SEQ_SERVE_PROMPTS = (768, 300, 40)  # two prompts at or above seq_parallel_min_tokens, one below


def _seq_faults():
    """The planted faults: (name, the implementation it runs under, "probe"
    (one ``seq_probe``, its attention gradients against sp 1's) or "step"
    (one ``train_batch`` step on a fresh engine, its grad norm against sp
    1's first step), a context that plants it)."""
    import contextlib
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.ops import ring_attention as ra

    @contextlib.contextmanager
    def patched(obj, attr, value):
        saved = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            yield
        finally:
            setattr(obj, attr, saved)

    raw = comm_mod._all_to_all_raw

    def reversed_members(tensor, pg, n, split_axis, concat_axis, tiled, group=None):
        import torch
        out = raw(tensor, pg, n, split_axis, concat_axis, tiled, group)
        return torch.cat(list(reversed(out.chunk(n, dim=concat_axis))), dim=concat_axis)

    return (("the ring's causal keep dropped (a wrapped future chunk merged)", "ring", "probe",
             lambda engine: patched(ra, "_sees_past", lambda idx, step: True)),
            # the engine's own reduction in the step (``_reduce_grads``) over
            # the data axes only: a group of one at dp 1
            ("the seq gradient sum left out", "ulysses", "step",
             lambda engine: patched(engine, "_grad_axes", dist.DP_AXES)),
            ("the Ulysses all-to-all member order reversed", "ulysses", "probe",
             lambda engine: patched(comm_mod, "_all_to_all_raw", reversed_members)))


def seq_gloo_check(torch, dev):
    """The seq axis's exchanges once each on ``dev`` tensors in the gloo
    group: the all-to-all (staged through host memory, logged) and a ring
    ``ppermute``, every result where the inputs say."""
    import deepspeed_tpu_torch.comm as dist
    r, n = dist.get_rank(dist.SEQ_AXIS), dist.get_world_size(dist.SEQ_AXIS)
    cl = dist.configure(enabled=True)
    x = (torch.arange(4 * n, device=dev) + 100 * r).to(torch.bfloat16).reshape(1, n, 4)
    got = dist.all_to_all_single(x, dist.SEQ_AXIS, 1, 2)
    want = torch.cat([(torch.arange(4 * n, device=dev) + 100 * i).reshape(1, n, 4)[:, r:r + 1]
                      for i in range(n)], dim=2).to(torch.bfloat16)
    check(got.device == x.device and torch.equal(got, want), f"seq gloo all_to_all: {got.tolist()}")
    ring = dist.ppermute(x, [(i, (i + 1) % n) for i in range(n)], dist.SEQ_AXIS)
    prev = (torch.arange(4 * n, device=dev) + 100 * ((r - 1) % n)).to(torch.bfloat16).reshape(1, n, 4)
    check(torch.equal(ring, prev), "seq gloo ppermute")
    staged = sum(c for sizes in cl.comms_dict.get("all_to_all_host_staged", {}).values() for c in sizes.values())
    dist.configure(enabled=False)
    check(staged == 1, f"seq gloo: {staged} host-staged all-to-alls logged, expected 1")
    return f"all_to_all and ppermute over seq on {x.device.type} tensors: ok, the all-to-all staged through host"


def _seq_batches(vocab):
    """One batch a step, and the probe's first: on one repeated batch the
    loss falls to ~1e-2 by the third step, where a relative gate reads
    rounding."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13)
    return [{"input_ids": rng.integers(0, vocab, (1, SEQ_LEN))} for _ in range(SEQ_STEPS)]


def seq_probe(torch, engine, batch, ref_dir=None):
    """One micro-step before any update: the loss and the attention weight
    gradients, summed over the engine's loss and gradient groups (the
    probed tensors only: the whole gradient's sum through gloo takes
    seconds, and the steps run it), and against sp 1's saved gradients
    under ``ref_dir`` (or, without it, saving them there) each one's
    relative L2 error."""
    import deepspeed_tpu_torch.comm as dist
    loss, grads = engine._micro_loss_and_grads(engine.master, engine._place(batch), 1.0)
    attn = {k: g for k, g in zip(engine.master, grads) if k in SEQ_PROBE_KEYS}
    del grads
    engine._reduce(list(attn.values()), engine._grad_axes, dist.ReduceOp.SUM)
    out = {"loss": float(dist.all_reduce(loss.float(), group=engine._loss_axes)), "rel": {}}
    if ref_dir is None:
        return out, {k: g.cpu() for k, g in attn.items()}
    ref = torch.load(os.path.join(ref_dir, "seq_probe.pt"))
    for k, g in attn.items():
        want = ref[k].to(g.device)
        out["rel"][k] = float(torch.linalg.vector_norm(g - want) / torch.linalg.vector_norm(want))
    del attn
    torch.cuda.empty_cache()
    return out, None


def seq_train(torch, dev, sp, impl, ref_dir, faults=()):
    """sp ``sp`` (the mesh's seq axis) under ``impl``: the engine on the
    seeded weights made on the card, the sound probe (sp 1 saves its
    attention gradients to ``ref_dir``), each planted fault's probe, then
    ``SEQ_STEPS`` steps: losses, grad norms, step ms, peak GiB and the
    kernels' launches; last, each planted fault of the "step" kind on an
    engine built afresh: its first step's loss and grad norm."""
    import deepspeed_tpu_torch
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
              "mesh": {"sequence_parallel_size": sp} if sp > 1 else {}}

    def build():
        model = _tp_whole_model(attention_impl="flash", sequence_parallel_impl=impl)
        params = random_params(torch, model, dev, SEED, int8=False)
        engine = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config,
                                                device=dev)[0]
        del params
        torch.cuda.empty_cache()
        return engine

    engine = build()
    batches = _seq_batches(engine.module.cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    probe, saved = seq_probe(torch, engine, batches[0], ref_dir if sp > 1 else None)
    if saved is not None:
        torch.save(saved, os.path.join(ref_dir, "seq_probe.pt"))
        del saved
    planted = {}
    for name, under, kind, plant in faults:
        if under == impl and kind == "probe":
            with plant(engine):
                planted[name] = seq_probe(torch, engine, batches[0], ref_dir)[0]
    reset_counts()
    losses, norms, ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(engine._last_metrics["grad_norm"]))
    out = {"probe": probe, "planted": planted, "losses": losses, "norms": norms, "ms": ms, "counts": read_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del engine
    torch.cuda.empty_cache()
    for name, under, kind, plant in faults:
        if under == impl and kind == "step":
            engine = build()
            with plant(engine):
                loss = float(engine.train_batch(batch=batches[0]))
            planted[name] = {"loss": loss, "norm": float(engine._last_metrics["grad_norm"])}
            del engine
            torch.cuda.empty_cache()
    return out


def seq_serve(torch, dev, sp):
    """llama3-8b int8 (2 layers, the default serving config) serving a
    4-slot stream of three requests (768 and 300 tokens: wide seq-parallel
    chunks; 40: base chunks), greedy and one sampled, with every step's
    logits and the launch counts; on the mesh's seq axis of ``sp`` the wide
    chunks' span attention splits over the ranks."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    model, tree = tp_int8_tree(torch, dev)
    eng = deepspeed_tpu_torch.init_inference(model, config=SEQ_SERVE_CONFIG,
                                             params=fuse_qkv(torch, tree, model.cfg.num_layers), device=dev)
    del tree
    vocab = eng.model_config.vocab_size
    rng = np.random.default_rng(SEED + 14)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in SEQ_SERVE_PROMPTS]
    sched = DecodeScheduler(eng, **SEQ_SERVE_SCHED)
    check((sched._seq_shards, sched._seq_chunk) == (sp, SEQ_SERVE_SCHED["prefill_chunk"] * SEQ_DEGREE),
          f"seq serving sp {sp}: shards / wide chunk {(sched._seq_shards, sched._seq_chunk)}")
    check(sched._fused_block, f"seq serving sp {sp}: the fused decode block is off ({sched._fused_block_reasons})")
    reset_counts()
    hs = [sched.submit(p, max_new_tokens=SEQ_SERVE_NEW) for p in prompts]
    hs.append(sched.submit(prompts[1], max_new_tokens=SEQ_SERVE_NEW, do_sample=True, temperature=0.8, top_k=50,
                           seed=SEED))
    t = time.perf_counter()
    while any(not h.done for h in hs):
        sched.step()
    torch.cuda.synchronize()
    out = {"tokens": [h.result().tolist() for h in hs], "logits": [np.stack(h.result_logits()) for h in hs],
           "s": time.perf_counter() - t, "counts": read_counts(), "forwards": dict(sched.forwards)}
    del sched, eng
    torch.cuda.empty_cache()
    return out


def seq_expected(cfg, impl, sp, steps):
    """Launches of ``steps`` steps a rank: Ulysses (and sp 1) one flash
    forward, dq and dk/dv a layer a step; the ring sp steps a layer, each
    run again in the backward (its checkpoint), so 2 sp forwards and sp dq
    and dk/dv a layer a step."""
    n = cfg.num_layers * steps
    if impl == "ring" and sp > 1:
        return {**ZERO_COUNTS, "flash_attention": 2 * sp * n, "flash_bwd_dq": sp * n, "flash_bwd_dkv": sp * n}
    return {**ZERO_COUNTS, "flash_attention": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def _seq_rank(rank, world, store, out_dir, dev):
    """One rank of the seq phase (a spawned process): the gloo group over
    the card, the mesh (seq = world), then training under each
    implementation with its planted faults, then serving; results to
    ``out_dir/rank{rank}.pt``, a traceback to ``rank{rank}.err``."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import deepspeed_tpu_torch.comm as dist
        dist.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                              verbose=False)
        dist.initialize_mesh(seq=world)
        res = {"gloo": seq_gloo_check(torch, dev)}
        faults = _seq_faults()
        res["train"] = {impl: seq_train(torch, dev, world, impl, out_dir, faults) for impl in SEQ_IMPLS}
        res["serve"] = seq_serve(torch, dev, world)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def seq_phase(torch, card, dev):
    """llama3-8b at full width (2 layers), bf16, seq 8192: sp 1 in this
    process against sp 2 as two ranks sharing the card (``_seq_rank``),
    under Ulysses and ring zig-zag: the first micro-step's attention weight
    gradients within ``SEQ_GRAD_REL`` relative L2 of sp 1's, the steps' losses
    and grad norms within ``SEQ_LOSS_REL`` / ``SEQ_NORM_REL`` and equal on
    the two ranks, exact flash launches a rank, peak GiB a rank; each fault
    of ``_seq_faults`` leaves its gate (a probe's the gradient gate, a
    step's the grad norm gate). Serving: the int8 stream at the serving
    defaults with seq-parallel prefill at sp 2, tokens and logits bitwise
    sp 1's on both ranks, launches equal. Returns one rank's launch counts of each
    implementation's steps and of the stream (``"serve"``), and sp 1's of
    its steps (``"sp1"``)."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    log(f"seq: {TP_MODEL} at full width, {TP_LAYERS} of 32 layers, bf16, micro 1, seq {SEQ_LEN}; sp 1 in this "
        f"process, sp {SEQ_DEGREE} as two processes sharing the card over a gloo group ({card})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    try:
        ref = seq_train(torch, dev, 1, "ulysses", tmp)
        cfg = _tp_whole_model().cfg
        check(ref["counts"] == seq_expected(cfg, "ulysses", 1, SEQ_STEPS), f"sp 1 launches {ref['counts']}")
        check(all(map(math.isfinite, ref["losses"] + ref["norms"])), "sp 1: non-finite loss or norm")
        log(f"sp 1: probe loss {ref['probe']['loss']}; losses {ref['losses']}, grad "
            f"norms {ref['norms']}, step ms {[round(x, 1) for x in ref['ms']]}, peak {ref['peak_gib']:.3f} GiB")
        serve_ref = seq_serve(torch, dev, 1)
        log(f"sp 1 serving: {sum(map(len, serve_ref['tokens']))} tokens in {serve_ref['s']:.3f} s, forwards "
            f"{serve_ref['forwards']}")
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_seq_rank, args=(r, SEQ_DEGREE, store, tmp, dev)) for r in range(SEQ_DEGREE)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SEQ_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = [open(os.path.join(tmp, f"rank{r}.err")).read() for r in range(SEQ_DEGREE)
                if os.path.exists(os.path.join(tmp, f"rank{r}.err"))]
        check(not alive, f"seq: {len(alive)} rank(s) still running after {SEQ_TIMEOUT_S} s; killed")
        check(not errs, "seq: a rank failed:\n" + "\n".join(errs))
        check(all(p.exitcode == 0 for p in procs), f"seq: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(SEQ_DEGREE)]
        log(f"sp {SEQ_DEGREE}: both ranks finished in {time.perf_counter() - t0:.1f} s (spawn, set-up, training, "
            f"planted faults, serving; two processes sharing one card)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    for r, res in enumerate(ranks):
        log(f"seq rank {r}: gloo {res['gloo']}")
        for impl, tr in res["train"].items():
            pr = tr["probe"]
            worst = max(pr["rel"].values())
            loss_rel = max(rel(a, b) for a, b in zip(tr["losses"], ref["losses"]))
            norm_rel = max(rel(a, b) for a, b in zip(tr["norms"], ref["norms"]))
            want = seq_expected(cfg, impl, SEQ_DEGREE, SEQ_STEPS)
            log(f"seq rank {r} {impl}: probe loss rel {rel(pr['loss'], ref['probe']['loss']):.2e}, attention "
                f"gradients rel L2 "
                f"{ {k.split('.', 1)[1]: round(v, 6) for k, v in pr['rel'].items()} } (gate {SEQ_GRAD_REL:g}); "
                f"losses {tr['losses']} (rel {loss_rel:.2e}, gate {SEQ_LOSS_REL:g}), grad norms {tr['norms']} "
                f"(rel {norm_rel:.2e}, gate {SEQ_NORM_REL:g}), peak {tr['peak_gib']:.3f} GiB (sp 1: "
                f"{ref['peak_gib']:.3f}), step ms {[round(x, 1) for x in tr['ms']]} (two processes sharing one "
                f"card), launches {tr['counts']}")
            check(all(map(math.isfinite, tr["losses"] + tr["norms"])), f"seq rank {r} {impl}: non-finite")
            check(worst <= SEQ_GRAD_REL, f"seq rank {r} {impl}: attention gradient rel L2 {worst:.3e} > "
                  f"{SEQ_GRAD_REL:g}")
            check(rel(pr["loss"], ref["probe"]["loss"]) <= SEQ_LOSS_REL, f"seq rank {r} {impl}: probe loss")
            check(loss_rel <= SEQ_LOSS_REL, f"seq rank {r} {impl}: loss rel {loss_rel:.2e} > {SEQ_LOSS_REL:g}")
            check(norm_rel <= SEQ_NORM_REL, f"seq rank {r} {impl}: norm rel {norm_rel:.2e} > {SEQ_NORM_REL:g}")
            first = ranks[0]["train"][impl]
            check(tr["losses"] == first["losses"] and tr["norms"] == first["norms"],
                  f"seq rank {r} {impl}: losses or norms differ from rank 0's")
            check(tr["counts"] == want, f"seq rank {r} {impl}: launches {tr['counts']} != {want}")
            for name, fp in tr["planted"].items():
                if "norm" in fp:  # a train_batch step: the first step's grad norm gate
                    bad = rel(fp["norm"], ref["norms"][0])
                    log(f"seq rank {r} planted fault ({name}), one train_batch step: loss {fp['loss']}, grad norm "
                        f"{fp['norm']} against sp 1's {ref['norms'][0]}: rel {bad:.3e} (the sound {impl} step "
                        f"{rel(tr['norms'][0], ref['norms'][0]):.3e}, gate {SEQ_NORM_REL:g})")
                    check(bad > SEQ_NORM_REL, f"seq rank {r}: the planted fault '{name}' passed the grad norm gate")
                    continue
                bad = max(fp["rel"].values())
                log(f"seq rank {r} planted fault ({name}): attention gradients rel L2 up to {bad:.3e} (the sound "
                    f"{impl} probe {worst:.3e}, gate {SEQ_GRAD_REL:g})")
                check(bad > SEQ_GRAD_REL, f"seq rank {r}: the planted fault '{name}' passed the gradient gate")
        check(sum(len(tr["planted"]) for tr in res["train"].values()) == 3, f"seq rank {r}: planted faults run")
        s = res["serve"]
        for key in ("tokens", "logits"):
            check(_tp_same(torch, s[key], serve_ref[key]), f"seq rank {r} serving {key}: not bitwise sp 1's "
                  f"(max |diff| {_tp_diff(torch, s[key], serve_ref[key]) if key == 'logits' else 'in the tokens'})")
        check(s["counts"] == serve_ref["counts"] and s["forwards"] == serve_ref["forwards"],
              f"seq rank {r} serving launches {s['counts']} / forwards {s['forwards']} != sp 1's "
              f"{serve_ref['counts']} / {serve_ref['forwards']}")
        log(f"seq rank {r} serving: {len(s['tokens'])} streams, tokens and {sum(len(x) for x in s['logits'])} step "
            f"logits bitwise sp 1's, launches equal ({ {k: v for k, v in s['counts'].items() if v} }), "
            f"{s['s']:.3f} s (two processes sharing one card)")
    return {**{impl: ranks[0]["train"][impl]["counts"] for impl in SEQ_IMPLS}, "serve": ranks[0]["serve"]["counts"],
            "sp1": ref["counts"]}


# ---------------------------------------------------------------------------
# phase 8b: the training engine's features on the training path

FEATURE_MODEL = "gpt2-large"
FEATURE_LAYERS = 18  # of 36: the depth cut so that the whole run stays inside its time limit
FEATURE_SEQ = 1024
REMAT_POLICIES = (None, "nothing_saveable", "dots_saveable", "dots_and_attn_saveable")
FEATURE_WARM, FEATURE_TIMED = 1, 3
DROPOUT = 0.1
DROPOUT_STEPS = 3
# the optimizers at gpt2-large width, depth cut to 4 layers, fp32 compute and
# the plain attention (no kernel), so the card and the CPU differ only in the
# order of their sums: OPT_STEPS steps on each, losses within OPT_LOSS_REL and the
# masters' difference within OPT_UPDATE_REL of what the CPU's updates moved.
# Lion's update is a sign: where (1 - b1) g + b1 m lies within rounding of 0
# the two sides may step by lr in opposite directions (PERF.md, PR 17: 5.4e-3
# of the update in three steps), so its limit is wider
OPT_LAYERS, OPT_BATCH, OPT_SEQ, OPT_STEPS = 4, 2, 128, 2
OPT_LOSS_REL = 1e-4
OPT_UPDATE_REL = {"Lion": 2e-2}
OPT_UPDATE_REL_DEFAULT = 1e-3
FEATURE_OPTIMIZERS = (
    ("Adam adam_w_mode false", {"type": "Adam", "params": {"lr": 1e-4, "weight_decay": 0.01,
                                                          "adam_w_mode": False}}),
    ("Adagrad", {"type": "Adagrad", "params": {"lr": 1e-3}}),
    ("LAMB", {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}),
    ("SGD momentum 0.9", {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}}),
    ("Lion", {"type": "Lion", "params": {"lr": 1e-5, "weight_decay": 0.1}}),
    ("client torch.optim.AdamW", None),
)


def check_train_counts(counts, want, what):
    check(counts == want, f"{what} launch counts {counts} != {want}")


def _same_or_close(a, b, rel, what):
    """'bitwise' when ``a == b``, else a check that they agree within
    ``rel`` and the reading."""
    if a == b:
        return "bitwise"
    r = abs(a - b) / abs(b)
    check(r <= rel, f"{what}: {a} vs {b} (rel {r:.3e} > {rel:g})")
    return f"within {rel:g} (rel {r:.3e})"


def _feature_engine(host, config, dev, optimizer=None, **model_kw):
    """An engine for ``FEATURE_MODEL`` on the host weights ``host`` (copied:
    on the CPU the engine would take fp32 host tensors as its master)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model_kw = {"attention_impl": "flash", "scan_layers": False, "num_layers": FEATURE_LAYERS, **model_kw}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=get_model(FEATURE_MODEL, **model_kw),
                                                     model_parameters={k: v.clone() for k, v in host.items()},
                                                     config=config, optimizer=optimizer, device=dev)
    return engine


def _steps(torch, engine, batch, n):
    """``n`` train steps: (losses, grad norms, step seconds)."""
    norms = []
    losses, secs = [], []
    for _ in range(n):
        loss, sec = timed_steps(torch, engine, batch, 1)
        losses += loss
        secs += sec
        norms.append(engine._last_metrics["grad_norm"])
    return losses, norms, secs


def remat_leg(torch, card, dev, host, batch):
    """gpt2-large at ``FEATURE_LAYERS`` layers under each of ``REMAT_POLICIES``: the first
    step's loss and grad norm against no remat, exact launch counts, the
    peak device memory and the median step over ``FEATURE_TIMED`` steps
    after ``FEATURE_WARM``, and a profile of one step. Returns {policy: (first-step loss, grad norm)}."""
    import numpy as np
    rows = {}
    for policy in REMAT_POLICIES:
        config = dict(TRAIN_CONFIG)
        if policy:
            config["activation_checkpointing"] = {"policy": policy}
        engine = _feature_engine(host, config, dev)
        check(engine.module.cfg.remat_policy == policy, f"remat policy {engine.module.cfg.remat_policy}")
        warm, norms, _ = _steps(torch, engine, batch, FEATURE_WARM)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, _, secs = _steps(torch, engine, batch, FEATURE_TIMED)
        counts, peak = read_counts(), torch.cuda.max_memory_allocated()
        check_train_counts(counts, expected_train_counts(engine.module.cfg, FEATURE_TIMED, policy=policy),
                           f"remat {policy}")
        check(all(np.isfinite(warm + losses)), f"remat {policy}: non-finite loss in {warm + losses}")
        rows[policy] = (warm[0], norms[0], peak, statistics.median(secs) * 1e3, counts["flash_attention"])
        train_profile(torch, engine, batch, rows[policy][3], f"{FEATURE_MODEL} remat {policy}", steps=1)
        del engine
        torch.cuda.empty_cache()
    base_loss, base_norm, base_peak, base_ms, _ = rows[None]
    for policy, (loss, norm, peak, ms, fwd) in rows.items():
        how = ""
        if policy is not None:
            how = (f"; first-step loss {_same_or_close(loss, base_loss, PARITY_LOSS_REL, f'remat {policy} loss')}"
                   f", grad norm {_same_or_close(norm, base_norm, PARITY_NORM_REL, f'remat {policy} norm')}"
                   f" of no remat's")
        log(f"remat {policy}: first step loss {loss:.6f} grad norm {norm:.6f}{how}; flash forward "
            f"launches {fwd} over {FEATURE_TIMED} steps; peak device memory {peak / 2**30:.3f} GiB "
            f"({peak / base_peak:.4f}x no remat); median step {ms:.3f} ms ({ms / base_ms:.4f}x) on {card}")
    check(rows["nothing_saveable"][2] < base_peak,
          f"nothing_saveable's peak {rows['nothing_saveable'][2]} is not below no remat's {base_peak}")
    return {p: r[:2] for p, r in rows.items()}


def dropout_leg(torch, dev, host, batch, no_dropout):
    """Dropout 0.1 under ``nothing_saveable``: two engines from one seed give
    bitwise losses over ``DROPOUT_STEPS`` steps (exact launch counts), and a
    first-step loss other than ``no_dropout``'s (the remat leg's (loss, grad
    norm) under ``nothing_saveable``); the first step's grad norm with remat
    off against on; the counter-hash mask on the card bitwise the CPU's at
    gpt2-large's (B, T, H)."""
    from deepspeed_tpu_torch.models.transformer import dropout_mask
    from deepspeed_tpu_torch.utils.counter_hash import fold_in, seed_key
    config = {**TRAIN_CONFIG, "activation_checkpointing": {"policy": "nothing_saveable"}}
    runs = []
    for _ in range(2):
        engine = _feature_engine(host, config, dev, dropout=DROPOUT)
        reset_counts()
        runs.append(_steps(torch, engine, batch, DROPOUT_STEPS))
        check_train_counts(read_counts(), expected_train_counts(engine.module.cfg, DROPOUT_STEPS,
                                                                policy="nothing_saveable"),
                           "dropout under nothing_saveable")
        del engine
        torch.cuda.empty_cache()
    (la, na, sa), (lb, _, _) = runs
    check(la == lb, f"dropout: two engines from one seed part: {la} vs {lb}")
    engine = _feature_engine(host, dict(TRAIN_CONFIG), dev, dropout=DROPOUT)
    _, nc, _ = _steps(torch, engine, batch, 1)
    del engine
    torch.cuda.empty_cache()
    how = _same_or_close(nc[0], na[0], PARITY_NORM_REL, "dropout: first-step grad norm, remat off vs on")
    log(f"dropout {DROPOUT} under nothing_saveable: losses {la} (bitwise on a second engine), steps "
        f"{[round(x * 1e3, 3) for x in sa]} ms; first-step loss {la[0]:.6f} (without dropout "
        f"{no_dropout[0]:.6f}); first-step grad norm remat on {na[0]:.6f}, off {nc[0]:.6f}: {how}")
    check(la[0] != no_dropout[0], "dropout left the first-step loss unchanged")
    B, H = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], host["embed.embedding"].shape[1]
    shape, key = (B, FEATURE_SEQ, H), fold_in(fold_in(seed_key(SEED), 1), 2)
    t0 = time.perf_counter()
    on_card = dropout_mask(key, shape, DROPOUT, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    on_host = dropout_mask(key, shape, DROPOUT, "cpu")
    same = torch.equal(on_card.cpu(), on_host)
    log(f"dropout mask {shape}: card == CPU bitwise: {same}; keep fraction {float(on_host.float().mean()):.6f} "
        f"(expected {1 - DROPOUT}); {card_s * 1e3:.3f} ms on the card, first call")
    check(same, "the counter-hash dropout mask differs between the card and the CPU")


def optimizer_leg(torch, dev):
    """Each optimizer type and a client ``torch.optim.AdamW``: ``OPT_STEPS``
    steps of the ``OPT_LAYERS``-layer model on the card against the same
    steps on the CPU."""
    import numpy as np
    from deepspeed_tpu_torch.models import get_model
    host = get_model(FEATURE_MODEL, num_layers=OPT_LAYERS).init_params(SEED)
    vocab = get_model(FEATURE_MODEL).cfg.vocab_size
    batch = {"input_ids": np.random.default_rng(SEED + 2).integers(0, vocab, (OPT_BATCH, OPT_SEQ))}
    config = {"train_micro_batch_size_per_gpu": OPT_BATCH, "gradient_clipping": 1.0,
              "steps_per_print": 10**9}
    model_kw = {"num_layers": OPT_LAYERS, "dtype": torch.float32, "attention_impl": "xla",
                "scan_layers": True}
    for name, section in FEATURE_OPTIMIZERS:
        cfg = dict(config) if section is None else {**config, "optimizer": section}
        out = []
        for d in (dev, torch.device("cpu")):
            client = None
            if section is None:
                client = lambda ps: torch.optim.AdamW(ps, lr=1e-4, weight_decay=0.01)  # noqa: E731
            engine = _feature_engine(host, cfg, d, optimizer=client, **model_kw)
            t0 = time.perf_counter()
            losses, _, _ = _steps(torch, engine, batch, OPT_STEPS)
            out.append((losses, {k: v.detach().cpu() for k, v in engine.params.items()},
                        time.perf_counter() - t0))
            del engine
            torch.cuda.empty_cache()
        (lk, mk, sk), (lc, mc, sc) = out
        moved = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(mc[k] - host[k])
                                                            for k in mc])))
        diff = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(mk[k] - mc[k])
                                                           for k in mc])))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lc))
        limit = OPT_UPDATE_REL.get(name, OPT_UPDATE_REL_DEFAULT)
        log(f"optimizer {name}: {OPT_STEPS} steps card vs CPU: losses {[round(x, 6) for x in lk]} vs "
            f"{[round(x, 6) for x in lc]} (worst rel {loss_rel:.3e}, limit {OPT_LOSS_REL:g}); masters "
            f"differ by {diff:.4e} against {moved:.4e} moved (rel {diff / moved:.3e}, limit "
            f"{limit:g}); {sk:.2f} s on the card, {sc:.2f} s on the CPU")
        check(moved > 0, f"optimizer {name}: the master did not move")
        check(loss_rel <= OPT_LOSS_REL, f"optimizer {name}: losses {lk} vs CPU {lc}")
        check(diff <= limit * moved, f"optimizer {name}: card and CPU masters differ by "
              f"{diff / moved:.3e} of the update")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def checkpoint_leg(torch, dev, host, batch):
    """gpt2-large at ``FEATURE_LAYERS`` layers: 2 steps, a sync save and an async save
    (steps 3 and 4 run while it writes), each loaded into a fresh engine
    whose steps 3 and 4 must be bitwise the uninterrupted run's, losses and
    master; save and load seconds and bytes; the 16-bit export loads back
    bitwise the bf16 cast of the master."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        a = _feature_engine(host, dict(TRAIN_CONFIG), dev)
        _steps(torch, a, batch, 2)
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.save_checkpoint(root, tag="sync2")
        times["sync save"] = time.perf_counter() - t0
        a.config.checkpoint.async_save = True
        t0 = time.perf_counter()
        a.save_checkpoint(root, tag="async2")
        times["async save returns"] = time.perf_counter() - t0
        a.config.checkpoint.async_save = False
        want, _, _ = _steps(torch, a, batch, 2)  # while the async file is written
        t0 = time.perf_counter()
        a.wait_checkpoint_saves()
        times["async wait after 2 steps"] = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(root, "sync2"))
        check(nbytes == _dir_bytes(os.path.join(root, "async2")), "sync and async checkpoints differ in size")
        for tag in ("sync2", "async2"):
            b = _feature_engine(host, dict(TRAIN_CONFIG), dev)
            with torch.no_grad():
                for v in b.params.values():
                    v.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.load_checkpoint(root, tag=tag)
            torch.cuda.synchronize()
            times[f"load {tag}"] = time.perf_counter() - t0
            got, _, _ = _steps(torch, b, batch, 2)
            same = all(torch.equal(b.params[k], v) for k, v in a.params.items())
            log(f"checkpoint {tag}: resumed losses {got} vs uninterrupted {want}; masters bitwise: {same}")
            check(got == want and same, f"checkpoint {tag}: the resumed run parts from the uninterrupted one")
            del b
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        path = a.save_16bit_model(os.path.join(root, "export"))
        times["16-bit export"] = time.perf_counter() - t0
        sd = torch.load(path, weights_only=True)
        exact = all(torch.equal(sd[k], v.detach().to(torch.bfloat16).cpu()) for k, v in a.params.items())
        log(f"checkpoint: {nbytes / 2**30:.3f} GiB a checkpoint (fp32 master and both Adam moments), "
            f"16-bit export {os.path.getsize(path) / 2**30:.3f} GiB, loads back bitwise the bf16 cast of "
            f"the master: {exact}; seconds {', '.join(f'{k} {v:.2f}' for k, v in times.items())} "
            f"(host file cache warm for the loads)")
        check(exact and set(sd) == set(a.params), "the 16-bit export is not the bf16 cast of the master")
        del a
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_features_phase(torch, card, dev):
    """Remat, dropout, the optimizers and checkpoints on the training path
    (``initialize`` -> ``train_batch``, bench.py's config), each leg timed."""
    import numpy as np
    from deepspeed_tpu_torch.models import get_model
    t0 = time.perf_counter()
    cfg = get_model(FEATURE_MODEL, num_layers=FEATURE_LAYERS).cfg
    host = get_model(FEATURE_MODEL, num_layers=FEATURE_LAYERS).init_params(SEED)
    B = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    batch = {"input_ids": np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, FEATURE_SEQ))}
    log(f"{FEATURE_MODEL} host weights ({cfg.num_layers} layers, seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s; batch ({B}, {FEATURE_SEQ})")
    first = timed_phase("training features: remat", remat_leg, torch, card, dev, host, batch)
    timed_phase("training features: dropout", dropout_leg, torch, dev, host, batch,
                first["nothing_saveable"])
    timed_phase("training features: optimizers", optimizer_leg, torch, dev)
    timed_phase("training features: checkpoints", checkpoint_leg, torch, dev, host, batch)


# ---------------------------------------------------------------------------
# phase 8c: the offload tiers (ZeRO-Offload, ZeRO-Infinity, ZeRO-Inference)

OFFLOAD_MODEL = "gpt2-large"
OFFLOAD_SEQ = 1024
STREAM_MODEL = "llama3-8b"
STREAM_SEQ = 2048
STREAM_BYTES_PER_PARAM = 18   # host bytes a streamed parameter may take (state, copies, staging)
STREAM_HOST_SHARE = 0.6       # of MemAvailable
STREAM_LOSS_REL = 1e-4        # streamed vs on-device: loss
STREAM_NORM_REL = 2e-2        # grad norm (bf16 gradients against the fp32 master's)
OFFLOAD_MASTER_REL = 1e-4     # masters after step 1, of the update's max magnitude
NVME_ENV = "CHIP_SMOKE_NVME_DIR"
# the NVMe leg's depth: its host AdamW reads and writes every moment through
# files (~15 s a step at 36 layers); its gate, bitwise the CPU tier at the
# same depth, holds at any depth. The cut keeps the whole run inside its
# time limit
NVME_LAYERS = 12
GEN_PROMPT, GEN_NEW = 128, 8


def _offload_engine(host, extra, dev, **model_kw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model = get_model(OFFLOAD_MODEL, attention_impl="flash", scan_layers=False, **model_kw)
    config = {**TRAIN_CONFIG, **extra}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=host, config=config,
                                                     device=dev)
    return engine


def _host_gib():
    from deepspeed_tpu_torch.runtime.zero.offload import PINNED
    return PINNED["registered"] / 2**30, PINNED["allocator"] / 2**30


def _mem_available():
    with open("/proc/meminfo") as f:
        info = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}
    return info["MemAvailable"], info["MemTotal"]


def _layer_params(name):
    from deepspeed_tpu_torch.models import get_model
    return get_model(name, num_layers=2).cfg.num_params() - get_model(name, num_layers=1).cfg.num_params()


def zero_offload_leg(torch, card, dev, host, batch):
    """(a) gpt2-large at full depth, bench.py's config, offload_optimizer
    cpu: the first step's loss bitwise the on-device engine's, the masters
    after it within ``OFFLOAD_MASTER_REL`` of the update, the loss falling
    over 3 + 5 steps; peak device memory, host GiB and the step split.
    Returns the masters after two steps (leg (b) holds NVMe to them)."""
    import numpy as np
    ref = _offload_engine({k: v.clone() for k, v in host.items()}, {}, dev)
    before = {k: v.detach().clone() for k, v in ref.master.items()}
    l_ref = float(ref.train_batch(batch=batch))
    upd = max(float((ref.master[k].detach() - before[k]).abs().max()) for k in before)
    after = {k: v.detach().clone() for k, v in ref.master.items()}
    cfg = ref.module.cfg
    del ref, before
    torch.cuda.empty_cache()
    eng = _offload_engine(host, {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, dev)
    reset_counts()
    l1 = float(eng.train_batch(batch=batch))
    master1 = eng.host_opt.state_tensors()[0]
    err = max(float((master1[k].to(after[k].device) - after[k]).abs().max()) for k in after) / upd
    log(f"(a) ZeRO-Offload {OFFLOAD_MODEL} ({cfg.num_layers} layers) step 1: loss {l1!r} vs on-device "
        f"{l_ref!r} ({'bitwise' if l1 == l_ref else 'DIFFERS'}); masters within {err:.3e} of the update's "
        f"max |{upd:.3e}| (limit {OFFLOAD_MASTER_REL:g}); host step {eng.last_offload_times}")
    check(l1 == l_ref, f"(a) offload first-step loss {l1!r} != on-device {l_ref!r}")
    check(err <= OFFLOAD_MASTER_REL, f"(a) offload masters {err:.3e} of the update from on-device AdamW")
    del after, master1
    losses = [l1]
    losses.append(float(eng.train_batch(batch=batch)))
    two = eng.host_opt.state_tensors()[0]
    losses += timed_steps(torch, eng, batch, 1)[0]
    torch.cuda.reset_peak_memory_stats()
    more, secs = timed_steps(torch, eng, batch, 5)
    losses += more
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_train_counts(counts, expected_train_counts(cfg, 8), "(a) ZeRO-Offload")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"(a) offload losses {losses}")
    reg, alloc = _host_gib()
    log(f"(a) losses over 3 + 5 steps {[round(x, 4) for x in losses]}; step (median of 5) "
        f"{statistics.median(secs) * 1e3:.3f} ms, last split {eng.last_offload_times} ms; peak device memory "
        f"{peak / 2**30:.3f} GiB (on-device AdamW: 17.125 GiB, PERF.md PR 17); host "
        f"{eng.host_opt.host_bytes() / 2**30:.3f} GiB held (pinned registered {reg:.3f} GiB, "
        f"allocator {alloc:.3f}); flash launches {counts['flash_attention']}/{counts['flash_bwd_dq']}/"
        f"{counts['flash_bwd_dkv']} over 8 steps on {card}")
    del eng
    torch.cuda.empty_cache()
    return two, counts


def nvme_leg(torch, card, dev, host, batch, two):
    """(b) the NVMe optimizer tier on gpt2-large at ``NVME_LAYERS`` layers
    (fewer, logged, where the disk cannot hold master and moments), 2
    steps: masters bitwise the CPU tier's at that depth (leg (a)'s at full
    depth); bytes read and written, O_DIRECT and buffered."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.models import get_model
    cfg = get_model(OFFLOAD_MODEL).cfg
    root = os.environ.get(NVME_ENV) or tempfile.gettempdir()
    path = tempfile.mkdtemp(prefix="chip_smoke_nvme_", dir=root)
    try:
        free = shutil.disk_usage(path).free
        per_layer = _layer_params(OFFLOAD_MODEL)
        L = min(cfg.num_layers, NVME_LAYERS)
        while L > 1 and 12 * (cfg.num_params() - (cfg.num_layers - L) * per_layer) > 0.8 * free:
            L -= 1
        extra = {"zero_optimization": {"offload_optimizer": {"device": "nvme", "nvme_path": path}}}
        if L < cfg.num_layers:
            log(f"(b) depth cut to {L} of {cfg.num_layers} layers (NVME_LAYERS {NVME_LAYERS}; {free / 2**30:.1f} "
                f"GiB free under {root})")
            keep = {k: v for k, v in host.items() if not k.startswith("layers.") or int(k.split(".")[1]) < L}
            ref = _offload_engine({k: v.clone() for k, v in keep.items()},
                                  {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, dev,
                                  num_layers=L)
            for _ in range(2):
                ref.train_batch(batch=batch)
            two = ref.host_opt.state_tensors()[0]
            del ref
            host = keep
        t0 = time.perf_counter()
        eng = _offload_engine(host, extra, dev, num_layers=L)
        t1 = time.perf_counter()
        secs = [timed_steps(torch, eng, batch, 1)[1][0] for _ in range(2)]
        got = eng.host_opt.state_tensors()[0]
        same = all(torch.equal(got[k], two[k]) for k in two)
        io = eng.host_opt.io_stats()
        log(f"(b) NVMe tier {OFFLOAD_MODEL} ({L} layers) under {path}: init {t1 - t0:.1f} s, steps "
            f"{[round(x * 1e3, 1) for x in secs]} ms, last split {eng.last_offload_times}; masters after 2 "
            f"steps {'bitwise' if same else 'DIFFER from'} the host tier's; read {io['bytes_read'] / 2**30:.3f} "
            f"GiB, written {io['bytes_written'] / 2**30:.3f} GiB; O_DIRECT read/write "
            f"{io['direct_read'] / 2**30:.3f}/{io['direct_write'] / 2**30:.3f} GiB, buffered "
            f"{io['buffered_read'] / 2**30:.3f}/{io['buffered_write'] / 2**30:.3f} GiB; "
            f"{free / 2**30:.1f} GiB free on {card}")
        check(same, "(b) NVMe-tier masters differ from the host tier's")
        del eng
    finally:
        shutil.rmtree(path, ignore_errors=True)


def _stream_config(extra=None):
    return {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1,
            "zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}, **(extra or {})}}


def _stream_batch(vocab):
    import numpy as np
    return {"input_ids": np.random.default_rng(SEED + 1).integers(0, vocab, (1, STREAM_SEQ))}


def stream_parity_leg(torch, card, dev):
    """(c), first part: llama3-8b at full width and 2 layers, stage 3 with
    offload_param cpu, seq 2048: the streamed step's loss and grad norm
    against the on-device engine's (as ``llama_train_phase`` builds it) on
    the same weights. Returns those weights (leg (d) decodes with them)."""
    import gc
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model = get_model(STREAM_MODEL, num_layers=2, attention_impl="flash")
    batch = _stream_batch(model.cfg.vocab_size)
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.initialize(model=model, config=_stream_config(), device=dev)[0]
    tree = eng.param_stream.get_params_tree()
    log(f"(c) streamed {STREAM_MODEL} at 2 layers built in {time.perf_counter() - t0:.1f} s "
        f"(blocks initialized on the device, {eng.param_stream.store.num_params():,} params)")
    ref = deepspeed_tpu_torch.initialize(model=get_model(STREAM_MODEL, num_layers=2, attention_impl="flash"),
                                         model_parameters={k: v.clone() for k, v in tree.items()},
                                         config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1},
                                         device=dev)[0]
    l_ref = float(ref.train_batch(batch=batch))
    n_ref = ref._last_metrics["grad_norm"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    l_s = float(eng.train_batch(batch=batch))
    n_s = eng._last_metrics["grad_norm"]
    log(f"(c) 2 layers, streamed vs on-device step: loss {l_s!r} vs {l_ref!r} "
        f"({_same_or_close(l_s, l_ref, STREAM_LOSS_REL, '(c) loss')}), grad norm {n_s:.6f} vs {n_ref:.6f} "
        f"({_same_or_close(n_s, n_ref, STREAM_NORM_REL, '(c) grad norm')})")
    del eng
    gc.collect()
    return tree


def zero_infinity_leg(torch, card, dev):
    """(c), second part: llama3-8b at full width and the deepest depth whose
    host state fits ``STREAM_HOST_SHARE`` of MemAvailable, 1 warm-up and 2
    timed steps with exact flash launches (2 L forwards, L dq, L dk/dv a
    step); peak device memory, host GiB, the step split, the overlap
    gauges, tokens/s and MFU."""
    import gc
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    T = STREAM_SEQ
    gc.collect()
    avail, total = _mem_available()
    full = get_model(STREAM_MODEL).cfg
    batch = _stream_batch(full.vocab_size)
    per_layer = _layer_params(STREAM_MODEL)
    rest = full.num_params() - full.num_layers * per_layer
    L = int(min(full.num_layers, (STREAM_HOST_SHARE * avail / STREAM_BYTES_PER_PARAM - rest) // per_layer))
    check(L >= 1, f"(c) host memory {avail / 2**30:.1f} GiB available holds no layer")
    model = get_model(STREAM_MODEL, num_layers=L, attention_impl="flash")
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.initialize(model=model, config=_stream_config(), device=dev)[0]
    ps = eng.param_stream
    log(f"(c) streamed {STREAM_MODEL} at {L} of {full.num_layers} layers (the deepest whose host state at "
        f"{STREAM_BYTES_PER_PARAM} B/param fits {STREAM_HOST_SHARE} of MemAvailable {avail / 2**30:.1f} GiB; "
        f"MemTotal {total / 2**30:.1f} GiB): {ps.store.num_params():,} params, built in "
        f"{time.perf_counter() - t0:.1f} s, host state {ps.store.host_bytes() / 2**30:.3f} GiB")
    warm = timed_steps(torch, eng, batch, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(torch, eng, batch, 2)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**ZERO_COUNTS, "flash_attention": 2 * 2 * L, "flash_bwd_dq": 2 * L, "flash_bwd_dkv": 2 * L}
    check_train_counts(counts, want, f"(c) streamed {STREAM_MODEL}")
    check(all(np.isfinite(warm[0] + losses)), f"(c) non-finite loss {warm[0] + losses}")
    pt = {k: round(v * 1e3, 3) if k.endswith("_s") else round(v, 4) for k, v in ps.last_phase_times.items()}
    step_s = statistics.median(secs)
    tok_s = T / step_s
    fpt = flops_per_token(model.cfg, T)
    reg, alloc = _host_gib()
    log(f"(c) losses {[round(x, 4) for x in warm[0] + losses]}, steps {[round(x * 1e3, 1) for x in secs]} ms "
        f"(warm-up {warm[1][0] * 1e3:.1f}); launches {counts} (2L/L/L a step: exact); peak device memory "
        f"{peak / 2**30:.3f} GiB; host state {ps.store.host_bytes() / 2**30:.3f} GiB (pinned registered "
        f"{reg:.3f}, allocator {alloc:.3f}); last step split (ms; adam summed over pool threads) {pt}; "
        f"{tok_s:.1f} tokens/s, MFU {fpt * tok_s / BF16_FLOP_PER_S:.4f} on {card}")
    del eng, ps
    gc.collect()
    torch.cuda.empty_cache()


def zero_inference_leg(torch, card, dev, tree):
    """(d) ``param_stream.generate`` on (c)'s 2-layer weights: greedy tokens
    equal the dense ``generate()``'s; decode kernel launches counted."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    model = get_model(STREAM_MODEL, num_layers=2, attention_impl="flash")
    cfg = model.cfg
    eng = deepspeed_tpu_torch.initialize(model=model, model_parameters=tree, config=_stream_config(),
                                         device=dev)[0]
    ids = np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (2, GEN_PROMPT)).astype(np.int32)
    reset_counts()
    t0 = time.perf_counter()
    out = eng.param_stream.generate(ids, max_new_tokens=GEN_NEW)
    sec = time.perf_counter() - t0
    counts = read_counts()
    want = {**ZERO_COUNTS, "flash_attention": 2, "decode_attention": 2 * (GEN_NEW - 1)}
    del eng
    dense = deepspeed_tpu_torch.init_inference(get_model(STREAM_MODEL, num_layers=2, attention_impl="flash"),
                                               config={"dtype": "bfloat16"}, params=tree, device=dev)
    ref = np.stack(dense.generate(ids, max_new_tokens=GEN_NEW))
    del dense
    torch.cuda.empty_cache()
    log(f"(d) ZeRO-Inference generate, 2 x {GEN_PROMPT} prompt, {GEN_NEW} new: {sec * 1e3:.1f} ms, tokens "
        f"{out[:, GEN_PROMPT:].tolist()} vs dense {ref.tolist()}; launches {counts} on {card}")
    check(np.array_equal(out[:, GEN_PROMPT:], ref), "(d) streamed greedy tokens differ from dense generate()")
    check_train_counts(counts, want, "(d) ZeRO-Inference generate")
    return counts


def offload_phase(torch, card, dev=None):
    """The offload tiers on the card: (a) ZeRO-Offload, (b) its NVMe tier,
    (c) ZeRO-Infinity on llama3-8b at full width, (d) ZeRO-Inference.
    Returns (a)'s and (d)'s launch counts."""
    import numpy as np
    from deepspeed_tpu_torch.models import get_model
    avail, total = _mem_available()
    log(f"host memory at the phase's start: MemAvailable {avail / 2**30:.1f} GiB of {total / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    cfg = get_model(OFFLOAD_MODEL).cfg
    host = get_model(OFFLOAD_MODEL).init_params(SEED)
    B = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    batch = {"input_ids": np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, OFFLOAD_SEQ))}
    log(f"{OFFLOAD_MODEL} host weights ({cfg.num_layers} layers, seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s; batch ({B}, {OFFLOAD_SEQ})")
    two, counts = timed_phase("offload: (a) ZeRO-Offload", zero_offload_leg, torch, card, dev, host, batch)
    timed_phase("offload: (b) NVMe tier", nvme_leg, torch, card, dev, host, batch, two)
    del two, host
    tree = timed_phase("offload: (c) ZeRO-Infinity at 2 layers", stream_parity_leg, torch, card, dev)
    gen_counts = timed_phase("offload: (d) ZeRO-Inference", zero_inference_leg, torch, card, dev, tree)
    del tree
    timed_phase("offload: (c) ZeRO-Infinity at depth", zero_infinity_leg, torch, card, dev)
    return counts, gen_counts


# the sparse path: gpt2-large's attention widths at T 4096, block 64, bf16
SPARSE_SHAPE = (2, 20, SPARSE_T, 64)
SPARSE_BLOCK = 64
SPARSE_KERNELS = ("block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")


def sparse_configs(H, block):
    """Each non-dense SparsityConfig at its defaults (Fixed unidirectional;
    LocalSlidingWindow is by default), and BigBird unidirectional, the
    causal-LM form, whose random blocks reach the diagonal."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    return [("Fixed uni", sa.FixedSparsityConfig(H, block=block, attention="unidirectional")),
            ("Variable", sa.VariableSparsityConfig(H, block=block)),
            ("BigBird", sa.BigBirdSparsityConfig(H, block=block)),
            ("BigBird uni", sa.BigBirdSparsityConfig(H, block=block, attention="unidirectional")),
            ("BSLongformer", sa.BSLongformerSparsityConfig(H, block=block)),
            ("LocalSlidingWindow", sa.LocalSlidingWindowSparsityConfig(H, block=block))]


def _out_and_grads(torch, fn, q, k, v, do):
    """(out, dq, dk, dv) of one attention call, through autograd."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(do)
    return (out.detach(), *(t.grad for t in leaves))


def _rel_l2(got, ref):
    """||got - ref|| / ||ref||, in fp32."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm())


def _row_rel_l2(torch, got, ref):
    """The largest ||got - ref|| / ||ref|| over the rows of the last axis;
    a row whose reference is all zeros (an empty window) counts 0 if it is
    all zeros too, else infinity."""
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    num, den = (g - r).norm(dim=1), r.norm(dim=1)
    rel = torch.where(den > 0, num / den.clamp_min(1e-30), torch.where(num > 0, float("inf"), 0.0))
    return float(rel.max())


def _bwd_row_rel_l2(torch, got, ref):
    """The largest ||got - ref|| / max(||ref||, FLASH_BWD_ROW_FLOOR * rms)
    over the rows of the last axis, rms the root mean square of the
    reference's row norms."""
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    num, den = (g - r).norm(dim=1), r.norm(dim=1)
    floor = max(FLASH_BWD_ROW_FLOOR * float(den.square().mean().sqrt()), 1e-30)
    return float((num / den.clamp_min(floor)).max())


def _call_mib(torch, fn):
    """MiB of device memory one call of ``fn`` allocates beyond what is held
    before it (its output and scratch), by the caching allocator's peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def _split_head(plan, sid, rows):
    """The head of split row ``sid`` of a WorkPlan."""
    return int(plan.items[plan.items[:, 3] == sid][0, 0]) // rows


def _dropped_block(plan, sid, piece):
    """A copy of ``plan`` whose item ``piece`` of split row ``sid`` walks one
    table position fewer (a planted fault of the merge)."""
    import copy

    import numpy as np
    bad = copy.copy(plan)
    bad.items = plan.items.copy()
    i = int(np.nonzero((plan.items[:, 3] == sid) & (plan.items[:, 1] == piece * plan.chunk))[0][0])
    bad.items[i, 2] -= 1
    bad._dev, bad._flags = {}, {}
    return bad


def _close(torch, got, ref, what, tags=("out", "dq", "dk", "dv")):
    """Each of out, dq, dk, dv (or ``tags``) within 2^-7 of max|ref| (one
    bf16 ulp at the largest magnitude) and within ``SPARSE_REL_L2``
    relative L2 error, finite; dq's rows also within
    ``FLASH_BWD_ROW_REL_L2`` (``_bwd_row_rel_l2``)."""
    errs = []
    for tag, a, r in zip(tags, got, ref):
        err, tol = float((a.float() - r.float()).abs().max()), 2.0**-7 * float(r.float().abs().max())
        rel = _rel_l2(a, r)
        check(bool(torch.isfinite(a.float()).all()), f"{what} {tag}: non-finite entries")
        check(err <= tol, f"{what} {tag}: max abs err {err:.3e} > {tol:.3e}")
        check(rel <= SPARSE_REL_L2, f"{what} {tag}: rel L2 err {rel:.3e} > {SPARSE_REL_L2:g}")
        errs.append(f"{tag} {err:.2e}/{tol:.2e} rel L2 {rel:.2e}")
        if tag == "dq":
            row = _bwd_row_rel_l2(torch, a, r)
            check(row <= FLASH_BWD_ROW_REL_L2,
                  f"{what} dq: a row's rel L2 err {row:.3e} > {FLASH_BWD_ROW_REL_L2:g}")
            errs[-1] += f" row {row:.2e}"
    return ", ".join(errs)


def sparse_attention_phase(torch):
    """``SparseSelfAttention`` forward and backward through autograd for
    each of ``sparse_configs`` at gpt2-large's widths: launch counts exactly
    1 forward, 1 dq, 1 dk/dv a call; two calls bitwise equal; one cached
    layout per sequence length; out and gradients against ``impl="plain"``
    (on the same work plans). Then the three kernels on the default plans,
    whose global rows and columns are split over CTAs, against one-piece
    plans, with each call's device memory; three planted faults that the
    relative-L2 gates must catch (a kv block dropped from a q block's
    count; a q block dropped from the second piece of a split column,
    which the dk/dv merge sums; a kv block dropped from the second piece
    of a split row, which the dq merge sums); the all-ones layout, causal, against the
    dense flash kernels; and the sparse forward+backward times beside dense
    flash's (a figure, not a gate). Returns the three kernels' launches over
    the checked calls."""
    import numpy as np
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention, make_block_sparse_attention
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        WorkPlan, block_sparse_bwd_dkv, block_sparse_bwd_dq, block_sparse_fwd)
    B, H, T, D = SPARSE_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    want = {**ZERO_COUNTS, **{n: 1 for n in SPARSE_KERNELS}}
    totals = dict.fromkeys(SPARSE_KERNELS, 0)
    fns = {}
    for label, cfg in sparse_configs(H, SPARSE_BLOCK):
        ssa = SparseSelfAttention(cfg)
        runs = []
        for _ in range(2):
            reset_counts()
            runs.append(_out_and_grads(torch, ssa, q, k, v, do))
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == want, f"sparse {label}: launch counts {counts} != {want}")
            for n in SPARSE_KERNELS:
                totals[n] += counts[n]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"sparse {label}: two calls on the same inputs differ")
        check(list(ssa._cache) == [T], f"sparse {label}: layout cache {list(ssa._cache)}, expected [{T}]")
        attn = ssa._cache[T]
        plain = make_block_sparse_attention(attn.layout, SPARSE_BLOCK, attn.causal, impl="plain")
        errs = _close(torch, runs[0], _out_and_grads(torch, plain, q, k, v, do), f"sparse {label}")
        cnt = attn.np_tables[1]
        log(f"sparse {label}: density {float(attn.layout.mean()):.4f}{' causal' if attn.causal else ''}, "
            f"kv blocks a q block min/median/max {int(cnt.min())}/{int(np.median(cnt))}/{int(cnt.max())}; "
            f"kernels vs plain: {errs}")
        fns[label] = ssa
    # the plans' cut walks against one piece a row: the three kernels on the
    # default plans (split global rows and columns, merged in piece order;
    # dq on the forward's) within the gates of the one-piece plans' outputs
    for label in ("Fixed uni", "BigBird"):
        attn = fns[label]._cache[T]
        q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
        whole = (WorkPlan(attn.np_tables[1]), WorkPlan(attn.np_tables[3]))
        got, ref = [], []
        for plans, res in ((attn.plans, got), (whole, ref)):
            out, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, SPARSE_BLOCK, attn.causal, plan=plans[0])
            delta = (do.float() * out.float()).sum(-1)
            res += [out, block_sparse_bwd_dq(q, k, v, do, lse, delta, q_idx, q_cnt, SPARSE_BLOCK, attn.causal,
                                             plan=plans[0]),
                    *block_sparse_bwd_dkv(q, k, v, do, lse, delta, kv_idx, kv_cnt, SPARSE_BLOCK, attn.causal,
                                          plan=plans[1])]
        errs = _close(torch, got, ref, f"sparse {label} split vs one-piece plans")
        mib = [_call_mib(torch, lambda: block_sparse_fwd(q, k, v, q_idx, q_cnt, SPARSE_BLOCK, attn.causal,
                                                         plan=attn.plans[0])),
               _call_mib(torch, lambda: block_sparse_bwd_dq(q, k, v, do, lse, delta, q_idx, q_cnt,
                                                            SPARSE_BLOCK, attn.causal, plan=attn.plans[0])),
               _call_mib(torch, lambda: block_sparse_bwd_dkv(q, k, v, do, lse, delta, kv_idx, kv_cnt,
                                                             SPARSE_BLOCK, attn.causal, plan=attn.plans[1]))]
        ws = [attn.plans[0].workspace_floats(B, SPARSE_BLOCK, D + 2) * 4 / 2**20,
              attn.plans[0].workspace_floats(B, SPARSE_BLOCK, D) * 4 / 2**20,
              attn.plans[1].workspace_floats(B, SPARSE_BLOCK, 2 * D) * 4 / 2**20]
        log(f"sparse {label}: {len(attn.plans[0].splits)} split rows, {len(attn.plans[1].splits)} split "
            f"columns; a call's MiB (outputs and workspace) forward {mib[0]:.2f} (workspace {ws[0]:.2f}), "
            f"dq {mib[1]:.2f} (workspace {ws[1]:.2f}), dk/dv {mib[2]:.2f} (workspace {ws[2]:.2f}); "
            f"cut walks vs one piece a row: {errs}")
    # planted fault: the forward kernel with one kv block dropped from the
    # walk of one q block (head 0, the median count of Fixed uni, causal:
    # the count the plan is built from) must fail the relative-L2 gate on
    # its own
    attn = fns["Fixed uni"]._cache[T]
    q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
    row = int(torch.argsort(q_cnt[0], stable=True)[q_cnt.shape[1] // 2])
    cut = q_cnt.clone()
    cut[0, row] -= 1
    good, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, SPARSE_BLOCK, attn.causal, plan=attn.plans[0])
    bad = block_sparse_fwd(q, k, v, q_idx, cut, SPARSE_BLOCK, attn.causal)[0]
    rel = _rel_l2(bad, good)
    log(f"sparse planted fault, Fixed uni head 0 q block {row} walks {int(cut[0, row])} of its "
        f"{int(q_cnt[0, row])} kv blocks: rel L2 {rel:.3e} (gate {SPARSE_REL_L2:g}), max abs "
        f"{float((bad.float() - good.float()).abs().max()):.3e}")
    check(rel > SPARSE_REL_L2, f"sparse planted fault: rel L2 {rel:.3e} passes the {SPARSE_REL_L2:g} gate")
    # planted fault of the merge: dk/dv with one q block dropped from the
    # second piece of the split global column of head 0 with the most pieces
    # (Fixed uni) must fail the gate too
    plan = attn.plans[1]
    sid = max((i for i in range(len(plan.splits)) if _split_head(plan, i, kv_idx.shape[1]) == 0),
              key=lambda i: int(plan.splits[i, 1]))
    bad_plan = _dropped_block(plan, sid, piece=1)
    delta = (do.float() * good.float()).sum(-1)
    args = (q, k, v, do, lse, delta, kv_idx, kv_cnt, SPARSE_BLOCK, attn.causal)
    ok = block_sparse_bwd_dkv(*args, plan=plan)
    faulty = block_sparse_bwd_dkv(*args, plan=bad_plan)
    rels = [_rel_l2(b, g) for b, g in zip(faulty, ok)]
    col = int(plan.items[plan.items[:, 3] == sid][0, 0]) % kv_idx.shape[1]
    log(f"sparse planted fault, Fixed uni head 0 kv block {col} ({int(plan.splits[sid, 1])} pieces of its "
        f"{int(kv_cnt[0, col])} q blocks), one q block dropped from piece 1: rel L2 dk {rels[0]:.3e}, "
        f"dv {rels[1]:.3e} (gate {SPARSE_REL_L2:g})")
    check(max(rels) > SPARSE_REL_L2,
          f"sparse dk/dv planted fault: rel L2 {max(rels):.3e} passes the {SPARSE_REL_L2:g} gate")
    # planted fault of the dq merge: dq with one kv block dropped from the
    # second piece of the split global row of head 0 with the most pieces
    # (BigBird, on the forward's plan) must fail dq's gates: it moves the
    # whole dq under SPARSE_REL_L2 (one row block of 40), so its row gate
    # must catch it
    attn = fns["BigBird"]._cache[T]
    q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
    plan = attn.plans[0]
    sid = max((i for i in range(len(plan.splits)) if _split_head(plan, i, q_idx.shape[1]) == 0),
              key=lambda i: int(plan.splits[i, 1]))
    out, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, SPARSE_BLOCK, attn.causal, plan=plan)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, q_idx, q_cnt, SPARSE_BLOCK, attn.causal)
    ok = block_sparse_bwd_dq(*args, plan=plan)
    faulty = block_sparse_bwd_dq(*args, plan=_dropped_block(plan, sid, piece=1))
    rel, row_rel = _rel_l2(faulty, ok), _bwd_row_rel_l2(torch, faulty, ok)
    qrow = int(plan.items[plan.items[:, 3] == sid][0, 0]) % q_idx.shape[1]
    log(f"sparse planted fault, BigBird head 0 q block {qrow} ({int(plan.splits[sid, 1])} pieces of its "
        f"{int(q_cnt[0, qrow])} kv blocks), one kv block dropped from piece 1: dq rel L2 {rel:.3e} "
        f"(gate {SPARSE_REL_L2:g}), a row's rel L2 {row_rel:.3e} (gate {FLASH_BWD_ROW_REL_L2:g})")
    check(row_rel > FLASH_BWD_ROW_REL_L2,
          f"sparse dq planted fault: a row's rel L2 {row_rel:.3e} passes the {FLASH_BWD_ROW_REL_L2:g} gate")
    nb = T // SPARSE_BLOCK
    dense = make_block_sparse_attention(np.ones((H, nb, nb), np.int64), SPARSE_BLOCK, causal=True)
    flash = lambda a, b, c: flash_attention(a, b, c, causal=True)
    errs = _close(torch, _out_and_grads(torch, dense, q, k, v, do),
                  _out_and_grads(torch, flash, q, k, v, do), "sparse all-ones causal vs flash")
    log(f"sparse all-ones layout, causal, vs the dense flash kernels: {errs}")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    flash_ms = cuda_ms(lambda: _out_and_grads(torch, flash, q, k, v, do), flush)
    times = {label: cuda_ms(lambda f=f: _out_and_grads(torch, f, q, k, v, do), flush)
             for label, f in list(fns.items()) + [("all-ones causal", dense)]}
    del flush
    log(f"sparse forward+backward ms at B={B} H={H} T={T} D={D} block {SPARSE_BLOCK} (L2 flushed): "
        + ", ".join(f"{lb} {ms:.4f}" for lb, ms in times.items())
        + f"; dense flash causal {flash_ms:.4f}")
    torch.cuda.empty_cache()
    return totals


def microbench_phase(torch):
    """The decode-shape microbench (``deepspeed_tpu_torch.benchmarks.
    qmm_microbench``), the main path of the qmm2, qmm3 and qmm4 kernels: all
    eight variants at L 36, R 64, each printing ms/pass, GB/s of weight
    bytes, relerr against bf16, the pass's byte bound and the per-launch
    time. Exact launch counts: per variant, 5 calls of R passes of L layers
    (one checked, 1 + 3 timed) and 4 x LAUNCH_REPS x L per-launch calls.
    Every output finite; the int8 variants within 5e-2 relerr of bf16 (the
    weights' int8 quantization error; JAX's file prints the same measure)."""
    from deepspeed_tpu_torch.benchmarks import qmm_microbench as mb
    reset_counts()
    results = mb.run(log=lambda line: log("microbench " + line))
    torch.cuda.synchronize()
    counts = read_counts()
    n = 5 * mb.R * mb.L + 4 * mb.LAUNCH_REPS * mb.L
    want = {**ZERO_COUNTS, "qmm2": 3 * n, "qmm3": n, "qmm4": n, "quant_matmul": n}
    log(f"microbench launches {counts}, expected {want}")
    check(counts == want, f"microbench launch counts {counts} != {want}")
    for r in results:
        check(r["finite"], f"microbench {r['name']}: non-finite output")
        check(r["name"] == "bf16" or 0 <= r["relerr"] <= 5e-2,
              f"microbench {r['name']}: relerr {r['relerr']:.4f} against bf16")
    return counts


def timed_phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main(argv=()):
    """``--kernels NAME[,NAME...]``: build those kernels and run only their
    rows of the kernel phase; ``--long``: build every kernel and run only the
    llama3-8b phase (its launch counts, streams and long-context legs with
    their peak device memory); ``--train-features``: build every kernel and
    run only the training-features phase; ``--offload``: build every
    kernel and run only the offload tiers' phase; ``--kv-tier``: build every
    kernel and run only the hierarchical KV tier's phase; ``--moe``: build
    every kernel and run only the mixtral-8x7b phase; ``--zero``: build every
    kernel and run only the ZeRO stages' phase; ``--tp``: build every
    kernel and run only the tensor-parallel phase (two ranks on the card);
    ``--pipe``: build every kernel and run only the pipeline phase (two
    ranks on the card); ``--seq``: build every kernel and run only the
    sequence-parallel phase (two ranks on the card); ``--fleet``: build
    every kernel and run only the serving fleet's phase (two replicas, phase
    roles, the router and its worker processes, the gateway on two ranks);
    ``--router``: build every kernel and run only the router leg (two
    routers and four gpt2-large worker processes on the card).
    Each compares a change with its parent in one call: run this file
    beside each tree's package, in turns."""
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
    global KERNELS
    only = argv[1].split(",") if len(argv) == 2 and argv[0] == "--kernels" else None
    if only is not None:
        KERNELS = [k for k in KERNELS if k[0] in only]
    t0 = time.perf_counter()
    logs = build.build_all([k[1].split("/")[-1][:-3] for k in KERNELS])  # each source once
    log(f"built {len(logs)} kernel sources in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma")):
                log(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    if list(argv) == ["--long"]:
        timed_phase("llama3-8b and long context", llama_phase, torch)
        log(card)
        return 0
    if list(argv) == ["--train-features"]:
        timed_phase("training features", train_features_phase, torch, card, dev)
        log(card)
        return 0
    if list(argv) == ["--offload"]:
        timed_phase("offload tiers", offload_phase, torch, card)
        log(card)
        return 0
    if list(argv) == ["--kv-tier"]:
        timed_phase("kv tier", kv_tier_phase, torch, card)
        log(card)
        return 0
    if list(argv) == ["--moe"]:
        timed_phase("mixtral-8x7b", moe_phase, torch, card)
        log(card)
        return 0
    if list(argv) == ["--zero"]:
        timed_phase("zero stages", zero_phase, torch, card, dev)
        log(card)
        return 0
    if list(argv) == ["--tp"]:
        timed_phase("tensor parallelism", tp_phase, torch, card, dev)
        log(card)
        return 0
    if list(argv) == ["--pipe"]:
        timed_phase("pipeline parallelism", pipe_phase, torch, card, dev)
        log(card)
        return 0
    if list(argv) == ["--seq"]:
        timed_phase("sequence parallelism", seq_phase, torch, card, dev)
        log(card)
        return 0
    if list(argv) == ["--fleet"]:
        timed_phase("fleet", fleet_phase, torch, card)
        log(card)
        return 0
    if list(argv) == ["--router"]:
        timed_phase("router", router_phase, torch, card)
        log(card)
        return 0
    results = timed_phase("kernels", kernel_phase, torch, dev)
    if only is not None:
        log(json.dumps({"kernels": list(results.values())}))
        return 0
    counts, fused_greedy, (serve_counts, int8_counts, shared_outs), params = timed_phase(
        "gpt2-large fused and serving", gpt2_large_phase, torch, card, fused=True)
    for name, n in counts.items():  # the static generate() path
        if name in results and n:
            results[name]["launches"] = n
    # the serving path: the paged modes from the mixed stream, the int8-KV
    # variants from the int8 leg
    for name in ("paged_decode_attention", "paged_span_attention"):
        results[name]["launches"] = serve_counts[name]
        results[name + "_int8"]["launches"] = int8_counts[name + "_int8"]
    # the serving gateway over HTTP on the same weights (its launches are
    # checked and logged there; the kernel rows keep the scheduler's)
    _, _, one_replica = timed_phase("gateway", gateway_phase, torch, card, params)
    # the serving fleet on the same weights, beside the gateway phase's one
    # replica (and the serving phase's shared-prefix streams as that
    # stream's one-replica reference): its two-replica stream's launches,
    # and a tp 2 rank's behind the gateway across ranks
    fleet_counts, fleet_tp_counts = timed_phase("fleet", fleet_phase, torch, card, params, one_replica,
                                                shared_outs)
    for key, counts in (("fleet_launches", fleet_counts), ("fleet_tp2_rank_launches", fleet_tp_counts)):
        for name, n in counts.items():
            if n and name in results:
                results[name][key] = n
    # the hierarchical KV tier on the same weights; its extent-paging leg
    # runs in the llama3-8b phase, on that engine
    timed_phase("kv tier", kv_tier_phase, torch, card, params, paging=False)
    # the per-projection engine on the same int8 tree (no second host-side quantize)
    _, unfused_greedy, _, _ = timed_phase("gpt2-large per-projection", gpt2_large_phase, torch, card,
                                          fused=False, params=params)
    del params
    torch.cuda.empty_cache()
    # the two paths round in other places (bias and RoPE in fp32 before the
    # cast in the fused kernels), so their streams may part where two logits
    # are close: reported, not required
    prefix = [next((i for i, (a, b) in enumerate(zip(f, u)) if a != b), len(f))
              for f, u in zip(fused_greedy, unfused_greedy)]
    log(f"gpt2-large greedy streams, fused vs per-projection: common prefix per row {prefix} "
        f"of {len(fused_greedy[0])}")
    long_counts, long_int8_counts = timed_phase("llama3-8b and long context", llama_phase, torch, card)
    # the extent modes from the long-context mixed stream and its int8 leg
    for name in ("extent_paged_decode", "extent_paged_span"):
        results[name]["launches"] = long_counts[name]
        results[name + "_int8"]["launches"] = long_int8_counts[name + "_int8"]
    # the training path is the main path of the backward kernels
    train_counts = timed_phase("training", train_phase, torch, card)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        results[name]["launches"] = train_counts[name]
    timed_phase("training parity", train_parity_phase, torch)
    timed_phase("llama3-8b training", llama_train_phase, torch)
    # mixtral-8x7b: its launches of the kernels it runs, beside the main paths'
    moe_serve, moe_train = timed_phase("mixtral-8x7b", moe_phase, torch, card)
    for counts, path in ((moe_serve, "a 4-slot stream"), (moe_train, f"{MOE_STEPS} training steps")):
        for name, n in counts.items():
            if n and name in results:
                results[name].setdefault("mixtral_launches", {})[path] = n
    timed_phase("training features", train_features_phase, torch, card, dev)
    timed_phase("offload tiers", offload_phase, torch, card)
    # ZeRO stages 0-3 on llama3-8b: the flash kernels' launches at stage 3
    zero_counts = timed_phase("zero stages", zero_phase, torch, card, dev)
    for name, n in zero_counts.items():
        if n and name in results:
            results[name].setdefault("zero_stage3_launches", {})[f"{ZERO_STEPS} llama3-8b steps"] = n
    # tensor parallelism 2 on llama3-8b: one rank's launches (each rank's are checked exact)
    tp_counts = timed_phase("tensor parallelism", tp_phase, torch, card, dev)
    for name, n in tp_counts.items():
        if n and name in results:
            results[name]["tp2_rank_launches"] = n
    # pipeline parallelism 2 on gpt2-large: one rank's launches (each rank's are checked exact)
    pipe_counts = timed_phase("pipeline parallelism", pipe_phase, torch, card, dev)
    for name, n in pipe_counts.items():
        if n and name in results:
            results[name]["pipe2_rank_launches"] = n
    # sequence parallelism 2 on llama3-8b: one rank's launches; the ring leg is
    # the main path of the ring rows (each rank's are checked exact); sp 1's
    # and a Ulysses rank's run the causal SEQ_FLASH_SHAPES rows
    seq_counts = timed_phase("sequence parallelism", seq_phase, torch, card, dev)
    for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        results[name + "_ring"]["launches"] = seq_counts["ring"][name]
        results[name]["seq1_launches"] = seq_counts["sp1"][name]
        results[name]["seq2_ulysses_rank_launches"] = seq_counts["ulysses"][name]
    results["paged_span_attention"]["seq2_prefill_rank_launches"] = seq_counts["serve"]["paged_span_attention"]
    # the sparse path is the main path of the three block-sparse kernels
    sparse_counts = timed_phase("block-sparse attention", sparse_attention_phase, torch)
    for name in SPARSE_KERNELS:
        results[name]["launches"] = sparse_counts[name]
    # the microbench is the main path of its three kernels
    micro_counts = timed_phase("microbench", microbench_phase, torch)
    for name in ("qmm2", "qmm3", "qmm4"):
        results[name]["launches"] = micro_counts[name]
    for name, r in results.items():
        check(r["launches"] and r["launches"] > 0, f"{name} was never launched on the main path")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)  # as nvidia-smi gives it: name, power limit
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
