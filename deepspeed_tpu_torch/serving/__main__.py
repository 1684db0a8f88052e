"""``python -m deepspeed_tpu_torch.serving``: run the serving gateway.

Port of ``deepspeed_tpu/serving/__main__.py``. Builds an
:class:`InferenceEngine` (continuous batching on) on the card, or on the
CPU with ``--device cpu`` or a config whose ``device`` key says so, binds
the HTTP gateway, and serves until SIGTERM/SIGINT, which drain it:
readiness flips to 503, admitted requests finish, telemetry flushes, and
the process exits 0. Prints one ``GATEWAY_READY`` JSON line (with the bound
port, ``--port 0`` binding an ephemeral one, and the process id) once
accepting traffic. ``kill -USR1`` writes a flight-recorder dump under the
telemetry directory.

Across ranks (``torchrun --nproc-per-node N -m deepspeed_tpu_torch.serving
--config cfg.json``, the config's ``tensor_parallel.tp_size`` dividing N):
every rank builds the engine over its shard; rank 0 serves and prints the
one ``GATEWAY_READY`` line, the other ranks follow it
(``serving.gateway.follow``) and ignore SIGTERM/SIGINT: SIGTERM to rank 0
drains every rank, and all exit 0. The ranks meet in a gloo group (NCCL
refuses two ranks on one card; gloo takes the card's tensors through host
memory); with a card, rank r runs on card ``r mod`` the cards present. A follower's telemetry writes under
``<output_path>/rank<r>``.

Multi-host modes (``serving/router.py``):

- ``--worker --router-url http://HOST:PORT``: the same gateway, joined to a
  cross-process fleet: it registers with the router, heartbeats its
  capacity signals and serves its shard of the networked prefix/handoff
  store. ``--worker-role prefill`` also hands finished prefills to decode
  workers through that store. ``GATEWAY_READY`` then carries
  ``worker_id`` and ``role``. One rank only: a worker across ranks raises
  (ROADMAP Queue 1 #9.2, its leftover).
- ``--router``: no model and no device: the router tier (placement, proxy
  and the store directory). Prints one ``ROUTER_READY`` JSON line; with
  ``--spawn-workers N`` it also starts N local workers (``--spawn-roles``
  their roles, and ``--model``, ``--config``, ``--device``, ``--dtype``,
  ``--num-slots`` and ``--kernel-inject`` passed through), which SIGTERM
  stops with it.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading


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
    p.add_argument("--hierarchical-kv", action="store_true",
                   help="enable the hierarchical KV tier (continuous_batching.hierarchical_kv): the "
                        "networked prefix/handoff store rides on it, so workers that hand off or "
                        "resume need it")
    mh = p.add_argument_group("multi-host serving (serving/router.py)")
    mh.add_argument("--worker", action="store_true",
                    help="join a cross-process worker fleet: register with --router-url, heartbeat "
                         "capacity signals, serve this process's shard of the networked store")
    mh.add_argument("--router-url", default=None, help="router base URL the worker registers with")
    mh.add_argument("--worker-id", default=None, help="fleet-unique worker id (default w<pid>)")
    mh.add_argument("--worker-role", default=None, choices=("prefill", "decode", "mixed"),
                    help="process-level phase role (default mixed); 'prefill' hands finished "
                         "prefills to decode workers over the networked store")
    mh.add_argument("--heartbeat-s", type=float, default=None,
                    help="heartbeat cadence (multihost.heartbeat_interval_s)")
    mh.add_argument("--lease-s", type=float, default=None, help="handoff claim deadline (multihost.lease_s)")
    mh.add_argument("--advertise-host", default=None, help="host other processes dial to reach this worker")
    mh.add_argument("--router", action="store_true",
                    help="run the router tier instead of a gateway (no model, no device): placement, "
                         "proxy and the store directory")
    mh.add_argument("--heartbeat-timeout-s", type=float, default=None,
                    help="router: a worker silent this long gets no placements")
    mh.add_argument("--spawn-workers", type=int, default=0,
                    help="router: also start N local worker processes (smoke tests, one-host fleets)")
    mh.add_argument("--spawn-roles", default=None,
                    help="router: comma-separated roles of the spawned workers (e.g. 'prefill,decode'); "
                         "default all mixed")
    return p


def worker_command(args, router_url, wid, role):
    """The command line of one worker the router spawns: this module in
    ``--worker`` mode with the router's model, config, device and serving
    flags."""
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.serving", "--worker", "--router-url", router_url,
           "--worker-id", wid, "--worker-role", role, "--model", args.model, "--port", "0"]
    if args.host is not None:
        cmd += ["--host", args.host]
    if role != "mixed" or args.hierarchical_kv:  # the handoff's transport, both ends
        cmd.append("--hierarchical-kv")
    if args.kernel_inject:
        cmd.append("--kernel-inject")
    for flag, name in (("config", "--config"), ("device", "--device"), ("dtype", "--dtype"),
                       ("num_slots", "--num-slots")):
        val = getattr(args, flag)
        if val is not None:
            cmd += [name, str(val)]
    return cmd


def run_router(args):
    """``--router``: the placement, proxy and directory tier. No engine and
    no device: host networking that can front any worker fleet."""
    from deepspeed_tpu_torch.serving.router import Router

    router = Router(host=args.host or "127.0.0.1", port=args.port if args.port is not None else 0,
                    heartbeat_timeout_s=args.heartbeat_timeout_s or 10.0).start_background()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(json.dumps({"event": "ROUTER_READY", "host": router.host, "port": router.port,
                      "pid": os.getpid()}), flush=True)
    roles = [r.strip() for r in args.spawn_roles.split(",") if r.strip()] if args.spawn_roles else []
    url = f"http://{router.host}:{router.port}"
    procs = []
    try:
        for i in range(args.spawn_workers):
            procs.append(subprocess.Popen(worker_command(args, url, f"w{i}",
                                                         roles[i] if i < len(roles) else "mixed")))
        while not stop.wait(0.2):
            pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        router.close()
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.router:
        return run_router(args)
    if args.worker and not args.router_url:
        parser.error("--worker requires --router-url")
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if args.worker:
        from deepspeed_tpu_torch.serving.router import refuse_ranks
        refuse_ranks(world)
    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    device = args.device or cfg.pop("device", None)
    cb = cfg.setdefault("continuous_batching", {})
    cb["enabled"] = True
    if args.num_slots is not None:
        cb["num_slots"] = args.num_slots
    if args.dtype is not None:
        cfg["dtype"] = args.dtype
    if args.kernel_inject:
        cfg["kernel_inject"] = True
    if args.hierarchical_kv:
        cb.setdefault("hierarchical_kv", {})["enabled"] = True
    if args.worker:
        mh_cfg = cb.setdefault("multihost", {})
        for flag, key in (("router_url", "router_url"), ("worker_id", "worker_id"),
                          ("worker_role", "worker_role"), ("heartbeat_s", "heartbeat_interval_s"),
                          ("lease_s", "lease_s"), ("advertise_host", "advertise_host")):
            val = getattr(args, flag)
            if val is not None:
                mh_cfg[key] = val
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
    if args.worker:
        rc = run_worker(gateway, engine._config.continuous_batching.multihost)
    else:
        rc = gateway.run()
    engine.telemetry.close()
    if world > 1:
        dist.destroy_process_group()
    return rc


def run_worker(gateway, mh):
    """``--worker``: serve through ``gateway`` with a
    :class:`~deepspeed_tpu_torch.serving.router.WorkerAgent` attached (the
    networked store shard, the migrate hook of a prefill worker, the
    register and heartbeat daemon) until the gateway drains."""
    from deepspeed_tpu_torch.serving.router import WorkerAgent

    gateway.start_background()
    agent = WorkerAgent(gateway, mh.router_url, mh.worker_id or f"w{os.getpid()}", role=mh.worker_role,
                        heartbeat_s=mh.heartbeat_interval_s, lease_s=mh.lease_s,
                        advertise_host=mh.advertise_host, migrate_min_tokens=mh.migrate_min_tokens)
    try:
        agent.attach()
    except ValueError:
        gateway.close()
        raise
    agent.start()
    print(json.dumps({"event": "GATEWAY_READY", "host": gateway.host, "port": gateway.port,
                      "pid": os.getpid(), "worker_id": agent.wid, "role": agent.role}), flush=True)
    while not gateway.wait_drained(0.2):
        pass
    agent.stop()
    if gateway.profiler is not None:
        gateway.profiler.stop()
    return 1 if gateway._fatal is not None else 0


if __name__ == "__main__":
    sys.exit(main())
