"""``python -m deepspeed_tpu_torch.serving``: run the serving gateway.

Port of ``deepspeed_tpu/serving/__main__.py`` without its multi-host
modes. Builds an :class:`InferenceEngine` (continuous batching on) on the
card, or on the CPU with ``--device cpu`` or a config whose ``device`` key
says so, binds the HTTP gateway, and serves until SIGTERM/SIGINT, which
drain it: readiness flips to 503, admitted requests finish, telemetry
flushes, and the process exits 0. Prints one ``GATEWAY_READY`` JSON line
(with the bound port, ``--port 0`` binding an ephemeral one, and the
process id) once accepting traffic. ``kill -USR1`` writes a
flight-recorder dump under the telemetry directory.

Across ranks (``torchrun --nproc-per-node N -m deepspeed_tpu_torch.serving
--config cfg.json``, the config's ``tensor_parallel.tp_size`` dividing N):
every rank builds the engine over its shard; rank 0 serves and prints the
one ``GATEWAY_READY`` line, the other ranks follow it
(``serving.gateway.follow``) and ignore SIGTERM/SIGINT: SIGTERM to rank 0
drains every rank, and all exit 0. The ranks meet in a gloo group (NCCL
refuses two ranks on one card; gloo takes the card's tensors through host
memory); with a card, rank r runs on card ``r mod`` the cards present. A follower's telemetry writes under
``<output_path>/rank<r>``.

``--router`` and ``--worker`` (the multi-host tiers) exit non-zero: they are
not ported yet (ROADMAP Queue 1 #9).
"""

import argparse
import json
import os
import signal
import sys

_ITEM9 = "ROADMAP Queue 1 #9, multi-host router"


def build_parser():
    p = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.serving",
                                description=__doc__.splitlines()[0])
    p.add_argument("--model", default="gpt2-large",
                   help="zoo model preset name (see deepspeed_tpu_torch.models)")
    p.add_argument("--config", default=None,
                   help="path to a DeepSpeedInferenceConfig JSON (flags below override its "
                        "gateway/serving sections); a top-level 'device' key picks the device")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain versions on the host; default the card")
    p.add_argument("--dtype", default=None, help="serving dtype (bf16/int8/...)")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None,
                   help="0 binds an ephemeral port (printed in GATEWAY_READY)")
    p.add_argument("--num-slots", type=int, default=None,
                   help="decode batch slots (continuous_batching.num_slots)")
    p.add_argument("--max-queue-depth", type=int, default=None)
    p.add_argument("--default-max-tokens", type=int, default=None)
    p.add_argument("--request-timeout-s", type=float, default=None)
    p.add_argument("--drain-timeout-s", type=float, default=None)
    p.add_argument("--kernel-inject", action="store_true",
                   help="serve through the paged decode and span kernels")
    p.add_argument("--worker", action="store_true",
                   help=f"join a cross-process worker fleet (not ported: {_ITEM9})")
    p.add_argument("--router", action="store_true",
                   help=f"run the router tier (not ported: {_ITEM9})")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.router or args.worker:
        print(f"deepspeed_tpu_torch.serving: --{'router' if args.router else 'worker'} is not "
              f"supported yet ({_ITEM9})", file=sys.stderr)
        return 2
    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    device = args.device or cfg.pop("device", None)
    cfg.setdefault("continuous_batching", {})["enabled"] = True
    if args.num_slots is not None:
        cfg["continuous_batching"]["num_slots"] = args.num_slots
    if args.dtype is not None:
        cfg["dtype"] = args.dtype
    if args.kernel_inject:
        cfg["kernel_inject"] = True
    gw_cfg = cfg.setdefault("gateway", {})
    for flag, key in (("host", "host"), ("port", "port"),
                      ("max_queue_depth", "max_queue_depth"),
                      ("default_max_tokens", "default_max_tokens"),
                      ("request_timeout_s", "request_timeout_s"),
                      ("drain_timeout_s", "drain_timeout_s")):
        val = getattr(args, flag)
        if val is not None:
            gw_cfg[key] = val

    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.serving import Gateway
    from deepspeed_tpu_torch.serving.gateway import follow

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        import torch
        if device != "cpu" and torch.cuda.is_available():
            torch.cuda.set_device(dist.get_local_rank() % torch.cuda.device_count())
        dist.init_distributed(dist_backend="gloo", verbose=False)
        rank = dist.get_rank()
        tel = cfg.get("telemetry")
        if rank and isinstance(tel, dict) and tel.get("output_path"):
            cfg["telemetry"] = {**tel, "output_path": os.path.join(tel["output_path"], f"rank{rank}")}
    engine = deepspeed_tpu_torch.init_inference(args.model, config=cfg, device=device)
    if world > 1 and dist.get_rank() != 0:
        # rank 0's drain stops this rank; a signal here must not cut it out
        # of the ranks' collectives
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        rc = follow(engine)
        engine.telemetry.close()
        dist.destroy_process_group()
        return rc
    gateway = Gateway(engine)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: gateway.begin_drain())
    if hasattr(signal, "SIGUSR1"):
        # operator-forced flight-recorder dump (kill -USR1 <pid>): the
        # handler only flags the request; the pump thread performs the dump
        signal.signal(signal.SIGUSR1, lambda *_: gateway.request_flight_dump("sigusr1"))
    rc = gateway.run()
    engine.telemetry.close()
    if world > 1:
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
