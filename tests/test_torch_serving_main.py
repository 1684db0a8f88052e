"""``python -m deepspeed_tpu_torch.serving`` as a subprocess on the CPU
(``--device cpu --port 0``): the ``GATEWAY_READY`` line, one completion
with a ``traceparent`` echoed, Prometheus text, a ``SIGUSR1`` flight dump,
and ``SIGTERM`` draining to exit 0; ``--router`` printing ``ROUTER_READY``
and exiting 0 on ``SIGTERM``, and ``--worker`` without ``--router-url``
exiting 2 with a usage error. Every wait is bounded."""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
START_S = 180


def _lines(proc):
    """A queue fed with the process's stdout lines by a reader thread."""
    q = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    return q


def _ready(q, token="GATEWAY_READY"):
    deadline = time.monotonic() + START_S
    seen = []
    while time.monotonic() < deadline:
        try:
            line = q.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        if line.startswith("{") and f'"{token}"' in line:
            return json.loads(line)
    raise AssertionError(f"no {token} line:\n" + "".join(seen[-20:]))


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_entry_point_serves_dumps_and_drains_on_sigterm(tmp_path):
    tel = tmp_path / "tel"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "dtype": "float32", "continuous_batching": {"num_slots": 2},
        "telemetry": {"enabled": True, "output_path": str(tel),
                      "flight_recorder": {"post_window_s": 0.0, "min_interval_s": 0.0}}}))
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.serving", "--model", "tiny",
                             "--config", str(cfg), "--device", "cpu", "--port", "0"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready = _ready(_lines(proc))
        port = ready["port"]
        status, headers, body = _request(port, "POST", "/v1/completions",
                                         {"prompt": [5, 6, 7, 8, 9], "max_tokens": 6},
                                         {"traceparent": TRACEPARENT})
        assert status == 200, body
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 6
        assert headers["x-request-id"] == TRACEPARENT.split("-")[1]
        assert headers["traceparent"] == TRACEPARENT
        status, headers, body = _request(port, "GET", "/v1/metrics", headers={"Accept": "text/plain"})
        assert status == 200 and b"dstpu_gateway_completed_total 1" in body
        proc.send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + 60
        while not any(n.startswith("flight_") and n.endswith("_sigusr1.json")
                      for n in os.listdir(tel)):
            assert time.monotonic() < deadline, "no SIGUSR1 flight dump"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
    with open(tel / "telemetry.jsonl") as f:
        names = {json.loads(line).get("name") for line in f}
    assert {"req/complete", "sched/step", "gateway/requests"} <= names


@pytest.mark.parametrize("flag", ["--router", "--worker"])
def test_multi_host_modes_exit_nonzero(flag):
    """The multi-host tiers' lifecycles: ``--router`` serves (no model, no
    device) until SIGTERM, then exits 0; ``--worker`` without
    ``--router-url`` is a usage error (exit 2) and builds nothing."""
    if flag == "--worker":
        r = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.serving", flag, "--device", "cpu"],
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert r.returncode == 2 and "--worker requires --router-url" in r.stderr
        assert "GATEWAY_READY" not in r.stdout
        return
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.serving", flag, "--port", "0"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready = _ready(_lines(proc), "ROUTER_READY")
        status, _, body = _request(ready["port"], "GET", "/v1/workers")
        assert status == 200 and json.loads(body) == {"workers": []}
        assert ready["pid"] == proc.pid
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
