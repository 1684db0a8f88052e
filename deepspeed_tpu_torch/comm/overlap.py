"""Realized-time and overlap accounting for communication.

Port of ``deepspeed_tpu/comm/overlap.py`` (``CommOverlapTracker``). Bytes
per op (``comm._record``) say nothing of whether a transfer hid behind
compute; this tracker does, for every host-observable flow:

- **dispatch**: wall time the calling thread spent issuing the transfer
  (a ``non_blocking`` copy or a collective on a side stream returns long
  before the card has done it);
- **realized**: issue to completion, fenced on an observer pool and folded
  into a per-op busy-interval union (k overlapping transfers count each
  wall second once; summing their durations would bias the efficiency
  towards 1);
- **exposed**: wall time the calling thread blocked on the transfer (a
  synchronous host collective exposes all of it; an asynchronous one that
  completes behind compute exposes nothing; a span measured on the card
  carries its own exposed time, :meth:`CommOverlapTracker.add_span`).

``overlap_efficiency = 1 - exposed / realized`` over every tracked op: the
definition ``offload/overlap_efficiency`` uses, so the two read on one
scale. The completion fence of a CUDA tensor is a CUDA event recorded on
the issuing stream, which an observer thread synchronizes; a CPU tensor is
complete when issued.

Tracked: the training batch's host-to-device placement
(``runtime/engine.py``), stage 3's block gathers (``all_gather``, timed on
the card by CUDA events: :meth:`CommOverlapTracker.add_span`), and the
control-plane ops ``barrier``, ``host_broadcast`` and ``host_allgather``
while a telemetry sink is live. The engine drains :meth:`collect` once a
step into ``comm/{op}/realized_ms``, ``comm/{op}/dispatch_ms`` and
``comm/overlap_efficiency`` gauges.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import torch

# one observer pool for completion fences (daemon threads: never hold exit)
_FENCE_POOL = ThreadPoolExecutor(max_workers=2, thread_name_prefix="comm-fence")


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def completion_event(value):
    """A CUDA event recorded on the current stream of the first CUDA tensor
    in ``value``, or None when ``value`` holds none (a CPU tensor is
    complete when issued)."""
    for t in _tensors(value):
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            return ev
    return None


class CommOverlapTracker:
    """Per-op dispatch / realized / exposed accounting with busy-interval
    unions. Thread-safe; ``collect(reset=True)`` is the per-step drain."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fences = []
        self._reset_locked()

    def _reset_locked(self):
        self._ops = {}   # op -> {"dispatch_s", "exposed_s", "calls"}
        self._busy = {}  # op -> [accumulated busy s, end of the last span]

    def _op(self, name):
        ent = self._ops.get(name)
        if ent is None:
            ent = self._ops[name] = {"dispatch_s": 0.0, "exposed_s": 0.0, "calls": 0}
            self._busy[name] = [0.0, 0.0]
        return ent

    def _bump_busy(self, op, t0, t1):
        """Fold the span [t0, t1] into ``op``'s busy-interval union (spans
        arrive roughly in completion order; one ending before the counted
        end lies inside the counted region)."""
        with self._lock:
            self._op(op)
            acc, last = self._busy[op]
            if t1 > last:
                self._busy[op] = [acc + t1 - max(t0, last), t1]

    # ------------------------------------------------------------------ producers
    def track_async(self, op, value, t0=None):
        """Account an already issued asynchronous transfer whose payload is
        ``value`` (tensors, or dicts and lists of them): the realized span
        runs from ``t0`` (default now; pass the stamp taken before the issue
        for an honest dispatch time) to the completion fence, observed off
        the calling thread (an event recorded now on the current stream of
        ``value``'s first CUDA tensor). Exposes nothing: the caller did not
        block. Returns ``value``."""
        now = time.perf_counter()
        t0 = now if t0 is None else t0
        with self._lock:
            ent = self._op(op)
            ent["dispatch_s"] += now - t0
            ent["calls"] += 1
        ev = completion_event(value)
        if ev is None:
            self._bump_busy(op, t0, now)
            return value

        def fence():
            try:
                ev.synchronize()
            except Exception:  # noqa: BLE001 (a failed stream ends the span too)
                pass
            self._bump_busy(op, t0, time.perf_counter())

        fut = _FENCE_POOL.submit(fence)
        with self._lock:
            if len(self._fences) > 128:
                self._fences = [f for f in self._fences if not f.done()]
            self._fences.append(fut)
        return value

    @contextmanager
    def track_host(self, op):
        """Bracket a synchronous host-context communication (barrier,
        host_broadcast, ...): its whole duration is dispatch, realized and
        exposed, since the caller was blocked for all of it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                ent = self._op(op)
                ent["dispatch_s"] += t1 - t0
                ent["exposed_s"] += t1 - t0
                ent["calls"] += 1
            self._bump_busy(op, t0, t1)

    def add_span(self, op, t0, t1, dispatch_s=0.0, exposed_s=0.0):
        """Account one transfer measured on another clock (the card's, from
        CUDA timing events): its span [t0, t1] joins ``op``'s busy union
        (spans of one op on one clock, folded in order of their start),
        with the host time spent issuing it and the time its consumer
        waited for it."""
        with self._lock:
            ent = self._op(op)
            ent["dispatch_s"] += dispatch_s
            ent["exposed_s"] += max(0.0, exposed_s)
            ent["calls"] += 1
        self._bump_busy(op, t0, t1)

    # ------------------------------------------------------------------ drain
    def join(self):
        """Block until every in-flight completion fence has landed (so a
        step's collect sees its own transfers, not the next step's)."""
        with self._lock:
            fences, self._fences = self._fences, []
        for f in fences:
            f.result()

    def collect(self, reset=True):
        """Per-op accounting and the overall overlap efficiency: each op's
        ``realized_s`` is its busy-interval union, and the efficiency is
        taken over the sum of the unions (the ops are distinct flows)."""
        self.join()
        with self._lock:
            ops, realized_total, exposed_total = {}, 0.0, 0.0
            for op, ent in self._ops.items():
                realized = self._busy[op][0]
                ops[op] = {"dispatch_s": ent["dispatch_s"], "exposed_s": ent["exposed_s"],
                           "realized_s": realized, "calls": ent["calls"]}
                realized_total += realized
                exposed_total += ent["exposed_s"]
            if reset:
                self._reset_locked()
        efficiency = (max(0.0, min(1.0, 1.0 - exposed_total / realized_total))
                      if realized_total > 0 else 0.0)
        return {"ops": ops, "realized_s": realized_total, "exposed_s": exposed_total,
                "overlap_efficiency": efficiency}


_tracker = CommOverlapTracker()


def get_overlap_tracker():
    """The process-global tracker (the engine drains it once a step)."""
    return _tracker
