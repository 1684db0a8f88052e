"""The serving gateway across ranks on gloo worlds of 2 on the CPU
(``tests/torch_dist_workers.py``): rank 0 runs the gateway, rank 1
``serving.gateway.follow``, and every step of a replica follows rank 0's
calls in lockstep on the replica's own process groups.

At tensor parallelism 2 (``tiny`` at fp32, the bitwise all-gather layout)
with 1 and 2 replicas, and at expert parallelism 2 (``tiny-moe``) with 2
replicas: every SSE stream of concurrent requests is bitwise the one-rank
engine's direct submit; a client that disconnects mid-decode frees its slot
on both ranks (both ranks' requests, tokens and cancels equal, the
cancelled one short of its budget). A follower planted to miss one cancel
is caught before it steps (it raises "ranks diverged" and stops), and
rank 0, its next exchange failing, fails the next request with 500 and
drains. Then ``python -m
deepspeed_tpu_torch.serving`` under ``torchrun --nproc-per-node 2`` at tp
2 on the CPU prints one ``GATEWAY_READY`` line, answers a completion with
the one-rank tokens, and on SIGTERM to rank 0 drains: both ranks and the
launcher exit 0.
"""

import functools
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import numpy as np

import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_dist_workers import gateway_ranks_world, run_world
from .torch_port_helpers import numpy_params, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = {"dtype": "float32", "kernel_inject": True, "max_out_tokens": 128, "fused_decode_block": False,
         "continuous_batching": {"enabled": True, "num_slots": 2}}
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(0, 256, n)]
           for s, n in ((1, 21), (2, 5), (3, 37), (4, 70), (5, 12), (6, 3))]
NEW = 8
START_S = 180


@functools.lru_cache(maxsize=None)
def _tree(name):
    return to_numpy(numpy_params(jm.get_model(name, max_seq_len=128), seed=10))


def _direct(name):
    """The one-rank engine's direct submits of PROMPTS."""
    model = tm.get_model(name, max_seq_len=128)
    eng = deepspeed_tpu_torch.init_inference(model, config=dict(SERVE), params=params_from_jax(_tree(name), model.cfg),
                                             device="cpu")
    sched = eng.scheduler()
    hs = [sched.submit(p, max_new_tokens=NEW) for p in PROMPTS]
    return [h.result().tolist() for h in hs]


def _check_served(r0, r1, ref, replicas):
    assert r0["fatal"] is None and r0["drained"] and r1["rc"] == 0 and "error" not in r1
    assert [s for s in r0["streams"]] == [(200, t) for t in ref]
    if replicas > 1:
        assert all(r0["dispatched"]), r0["dispatched"]  # both replicas placed
    status, toks = r0["disconnected"]
    assert status == 200 and len(toks) >= 2
    assert r0["freed"] and r0["stats"]["disconnects"] == 1
    # the same requests with the same tokens and cancels on both ranks (made
    # in another order across replicas: each replica's pump applies its own)
    assert sorted(r0["reqs"]) == sorted(r1["reqs"]) and len(r0["reqs"]) == len(PROMPTS) + 1
    rid, out, cancelled = r0["reqs"][-1]
    assert cancelled and 2 <= len(out) < 100


def test_gateway_at_tp2_serves_in_lockstep(tmp_path):
    ref = _direct("tiny")
    cases = [("tiny", "tiny", SERVE, {"tensor": 2}, PROMPTS, NEW, replicas, False) for replicas in (1, 2)]
    r0, r1 = run_world(gateway_ranks_world, 2, tmp_path, {"tiny": _tree("tiny")}, cases, timeout=240)
    for (a, b), replicas in zip(zip(r0, r1), (1, 2)):
        _check_served(a, b, ref, replicas)


def test_gateway_at_ep2_serves_in_lockstep(tmp_path):
    ref = _direct("tiny-moe")
    cases = [("tiny-moe", "moe", SERVE, {"expert": 2}, PROMPTS, NEW, 2, False)]
    (r0, ), (r1, ) = run_world(gateway_ranks_world, 2, tmp_path, {"moe": _tree("tiny-moe")}, cases, timeout=240)
    _check_served(r0, r1, ref, 2)


def test_follower_missing_a_cancel_is_caught(tmp_path):
    cases = [("tiny", "tiny", SERVE, {"tensor": 2}, PROMPTS, NEW, 1, True)]
    (r0, ), (r1, ) = run_world(gateway_ranks_world, 2, tmp_path, {"tiny": _tree("tiny")}, cases, timeout=240)
    # the follower stops before the step that would wait on rank 0 forever
    assert "ranks diverged" in r1["error"] and "cancelled" in r1["error"]
    # rank 0's next exchange fails with the follower gone: it fails the
    # request and drains
    assert r0["fatal"] is not None and r0["drained"] and r0["after"][0] == 500
    assert r0["reqs"][-2][2] and not r1["reqs"][-1][2]


def _lines(proc):
    q = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    return q


def test_entry_point_under_torchrun_drains_every_rank(tmp_path):
    # the entry point builds the preset on seeded random weights, whole, and
    # shards them: the one-rank engine on the same weights is the reference
    eng = deepspeed_tpu_torch.init_inference("tiny", config=dict(SERVE), device="cpu")
    ref = eng.scheduler().submit(PROMPTS[0], max_new_tokens=NEW).result().tolist()
    del eng
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**SERVE, "tensor_parallel": {"tp_size": 2}}))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                             "-m", "deepspeed_tpu_torch.serving", "--model", "tiny", "--config", str(cfg),
                             "--device", "cpu", "--port", "0"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    q = _lines(proc)
    seen, ready = [], []
    try:
        deadline = time.monotonic() + START_S
        while not ready and time.monotonic() < deadline:
            line = q.get(timeout=max(0.1, deadline - time.monotonic()))
            if line is None:
                break
            seen.append(line)
            if '"GATEWAY_READY"' in line:
                ready.append(json.loads(line[line.index("{"):]))
        assert ready, "no GATEWAY_READY line:\n" + "".join(seen[-30:])
        port = ready[0]["port"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/completions", json.dumps({"prompt": PROMPTS[0], "max_tokens": NEW}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 200 and body["choices"][0]["token_ids"] == ref
        os.kill(ready[0]["pid"], signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, "".join(seen[-30:])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)  # the launcher and both ranks
            proc.wait(timeout=60)
    while True:
        line = q.get(timeout=60)
        if line is None:
            break
        seen.append(line)
    assert sum('"GATEWAY_READY"' in line for line in seen) == 1
