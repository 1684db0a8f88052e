"""The streaming layer (``memory/streams.py``) and the ZeRO-Infinity
pipeline's guards, mirrored from the JAX package's
``tests/unit/memory/test_streams.py`` and ``tests/unit/test_offload_stream.py``:
the executor's staging generations, fetch window, depth-0 fencing and
busy-interval union; the read window; every ``prefetch_depth`` x
``fetch_window`` setting bitwise the unpipelined step on the host and NVMe
tiers and with gradient accumulation; the overlap gauges in the telemetry.
One card test holds the ZeRO-Offload push to the host's bf16 copy under a
busy compute stream (a missing fence shows there); on the card, from the
repo root: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_offload_stream.py``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.memory import AioReadWindow, LayerStreamExecutor
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig


def token_batch(seed, n, T):
    # not from torch_port_helpers, which imports JAX: the card test below
    # runs where there is none (``pytest --noconftest -m cuda``)
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (n, T)).astype(np.int32)}


def test_reexport_paths_are_one_class():
    from deepspeed_tpu_torch.memory.streams import LayerStreamExecutor as FromStreams
    from deepspeed_tpu_torch.runtime.swap_tensor import AioReadWindow as FromSwap
    from deepspeed_tpu_torch.runtime.zero.param_offload import LayerStreamExecutor as FromOffload
    assert FromStreams is LayerStreamExecutor is FromOffload
    assert FromSwap is AioReadWindow


def _executor(depth=0, window=2, dispatch=None):
    return LayerStreamExecutor(dispatch or (lambda name: {"w": torch.zeros(4)}), None, depth, window)


def test_stage_grad_generation_overwrites_then_accumulates():
    ex = _executor()
    a = ex.stage_grad("blk", "w", torch.full((3, ), 2.0), torch.float32)
    b = ex.stage_grad("blk", "w", torch.full((3, ), 3.0), torch.float32)
    assert a is b and torch.equal(b, torch.full((3, ), 5.0))
    ex.begin_step()
    c = ex.stage_grad("blk", "w", torch.full((3, ), 7.0), torch.float32)
    assert c is a and torch.equal(c, torch.full((3, ), 7.0))
    d = ex.stage_grad("blk", "w", torch.full((5, ), 1.0), torch.float32)
    assert d is not a and d.shape == (5, )


def test_fetch_window_bounds_in_flight_work():
    ex = _executor(window=2)
    gate = threading.Event()
    done = []

    def blocked():
        gate.wait(5.0)
        done.append("slow")

    ex.submit_fetch(blocked)
    ex.submit_fetch(lambda: done.append("a"))
    t0 = time.perf_counter()
    gate.set()
    ex.submit_fetch(lambda: done.append("b"))
    assert time.perf_counter() - t0 < 4.0
    ex.drain_fetches()
    assert sorted(done) == ["a", "b", "slow"]
    assert ex.stats["fetch_wait_s"] >= 0.0


def test_drain_surfaces_a_failed_fetch():
    ex = _executor()

    def boom():
        raise OSError("planted")
    ex.submit_fetch(boom)
    with pytest.raises(OSError, match="planted"):
        ex.drain_fetches()


def test_depth0_take_is_fenced_point_of_use():
    calls = []
    ex = _executor(depth=0, dispatch=lambda name: calls.append(name) or {"w": torch.ones(2)})
    ex.prefetch(["x", "y"])
    assert calls == [] and ex._puts == {}
    out = ex.take("x")
    assert calls == ["x"] and torch.equal(out["w"], torch.ones(2))
    st = ex.collect_stats()
    assert st["puts"] == 1 and st["puts_prefetched"] == 0
    assert st["put_dispatch_s"] > 0.0 and st["put_realized_s"] > 0.0
    assert not ex._fences


def test_depth_prefetch_marks_lookahead_puts():
    ex = _executor(depth=2)
    ex.take("a", ahead=["b", "c", "d"])
    assert set(ex._puts) == {"b", "c"}
    ex.take("b")
    st = ex.collect_stats()
    assert st["puts"] == 2 and st["puts_prefetched"] == 1
    ex.invalidate()
    assert ex._puts == {}


def test_schedule_state_prefetch_tolerates_no_store():
    _executor(depth=2).schedule_state_prefetch(["a", "b"])

    class Store:
        seen = None

        def schedule_state_prefetch(self, names):
            self.seen = list(names)

    st = Store()
    LayerStreamExecutor(lambda n: {}, st, 2, 1).schedule_state_prefetch(["a", "b", "c"])
    assert st.seen == ["a", "b"]


def test_busy_union_counts_overlap_once():
    ex = _executor()
    ex._bump_busy("put", 0.0, 1.0)
    ex._bump_busy("put", 0.5, 1.5)
    ex._bump_busy("put", 0.2, 1.2)
    assert ex._busy["put"][0] == pytest.approx(1.5)


def test_aio_read_window_round_trip(tmp_path):
    data = np.arange(4096, dtype=np.uint8)
    path = str(tmp_path / "blob")
    data.tofile(path)
    win = AioReadWindow(2, dict(block_size=1 << 20, queue_depth=4, single_submit=False,
                                overlap_events=True, thread_count=1))
    slot = win.acquire()
    buf = slot.buffers(1024, 1)[0]
    assert buf.data_ptr() % 4096 == 0
    slot.handle.async_pread(buf.view(torch.uint8), path)
    slot.handle.wait()
    assert np.array_equal(buf.view(torch.uint8).numpy(), data)
    win.release(slot)
    assert win.acquire() is not None and win.acquire() is not None
    assert win.acquire() is None


# ---------------------------------------------------------------------------
# the pipeline moves bytes, never math


def _cfg(depth, window, device="cpu", nvme_path=None, gas=1, clip=0.5, telemetry=None):
    offp = {"device": device}
    if nvme_path:
        offp["nvme_path"] = str(nvme_path)
    cfg = {"train_batch_size": 8 * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": clip,
           "zero_optimization": {"stage": 3, "offload_param": offp,
                                 "offload_optimizer": {"prefetch_depth": depth, "fetch_window": window}},
           "steps_per_print": 1}
    if telemetry:
        cfg["telemetry"] = telemetry
    return cfg


@pytest.fixture(scope="module")
def baseline_params():
    e = deepspeed_tpu_torch.initialize(model=get_model("tiny", dtype=torch.float32), config=_cfg(0, 1),
                                       device="cpu")[0]
    return e.param_stream.get_params_tree()


def _train(cfg, params, steps=2, gas=1):
    e = deepspeed_tpu_torch.initialize(model=get_model("tiny", dtype=torch.float32), config=cfg,
                                       model_parameters=params, device="cpu")[0]
    runner = e.param_stream
    assert runner.prefetch_depth == cfg["zero_optimization"]["offload_optimizer"]["prefetch_depth"]
    losses = [float(e.train_batch(batch=token_batch(i % 2, n=8 * gas, T=16))) for i in range(steps)]
    return losses, runner.get_params_tree(), runner.last_phase_times


def _assert_identical(a, b, label):
    assert a[0] == b[0], (label, a[0], b[0])
    assert list(a[1]) == list(b[1])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), (label, k)


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("window", [1, 4])
def test_host_parity_across_depth_and_window(depth, window, baseline_params):
    """Loss and masters bitwise the unpipelined step at every depth and
    window (the streaming apply, gas 1, clipping on: the norm adds in a
    fixed order)."""
    base = _train(_cfg(0, 1), baseline_params)
    run = _train(_cfg(depth, window), baseline_params)
    _assert_identical(base, run, f"depth={depth} window={window}")
    if depth:
        assert run[2]["put_realized_s"] > 0.0 and 0.0 <= run[2]["overlap_efficiency"] <= 1.0


def test_nvme_parity_across_depth(tmp_path, baseline_params):
    base = _train(_cfg(0, 1, "nvme", tmp_path / "a"), baseline_params)
    run = _train(_cfg(2, 4, "nvme", tmp_path / "b"), baseline_params)
    _assert_identical(base, run, "nvme depth=2 window=4")
    _assert_identical(base, _train(_cfg(0, 1), baseline_params), "nvme == cpu")


def test_buffered_gas_parity(baseline_params):
    base = _train(_cfg(0, 1, gas=2), baseline_params, gas=2)
    run = _train(_cfg(2, 2, gas=2), baseline_params, gas=2)
    _assert_identical(base, run, "gas=2 depth=2")


def test_overlap_gauges_reach_the_sink(tmp_path, baseline_params):
    cfg = _cfg(2, 4, telemetry={"enabled": True, "output_path": str(tmp_path)})
    _train(cfg, baseline_params, steps=2)
    from deepspeed_tpu_torch.telemetry import get_sink
    get_sink().flush()
    names = set()
    for path in (p for p in os.listdir(tmp_path) if p.endswith(".jsonl")):
        with open(tmp_path / path) as f:
            names |= {json.loads(line).get("name") for line in f if line.strip()}
    for gauge in ("offload/put_dispatch_ms", "offload/put_realized_ms", "offload/fetch_wait_ms",
                  "offload/overlap_efficiency"):
        assert gauge in names, (gauge, sorted(n for n in names if n)[:20])


def test_config_knobs_parse_and_validate():
    z = DeepSpeedZeroConfig({"offload_optimizer": {"prefetch_depth": 3, "fetch_window": 2}})
    assert z.offload_optimizer.prefetch_depth == 3 and z.offload_optimizer.fetch_window == 2
    with pytest.raises(ValueError):
        DeepSpeedZeroConfig({"offload_optimizer": {"prefetch_depth": -1}})
    with pytest.raises(ValueError):
        DeepSpeedZeroConfig({"offload_optimizer": {"fetch_window": 0}})


# ---------------------------------------------------------------------------
# the card


@pytest.mark.cuda
def test_offload_push_is_fenced_under_a_busy_compute_stream():
    """Three host steps, each enqueued behind 50 ms of busy compute stream:
    the device's compute copy after each push is bitwise the host's bf16
    copy of that step (the host must not rewrite the pinned copy before the
    previous push read it), and each fetch saw that step's gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy streams and pinned buffers exist only there")
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    dev = torch.device("cuda")
    cfg = DeepSpeedConfig({"train_batch_size": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": torch.randn(3 << 20, generator=gen) for i in range(3)}
    opt = HostOffloadOptimizer(cfg.optimizer, dev, torch.bfloat16)
    opt.init(params)
    for step in range(3):
        torch.cuda._sleep(100_000_000)  # the compute stream stays busy while the host steps
        opt.dev_grad.fill_(float(step + 1))  # this step's gradient, behind the sleep
        opt.step(1.0, 1e-2)
        host = opt.host_c.clone()  # what this step pushed
        got = opt.dev_c.clone()    # the current stream waits on the push's event
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int16), host.view(torch.int16)), step
        assert torch.equal(opt.grad_host, torch.full_like(opt.grad_host, float(step + 1))), step
