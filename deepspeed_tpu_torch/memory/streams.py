"""Device <-> host <-> NVMe streaming layer.

Port of ``deepspeed_tpu/memory/streams.py``: the transfer executor the
ZeRO-Infinity parameter stream (``runtime/zero/param_offload.py``) rides.
:class:`LayerStreamExecutor` pipelines four flows against compute:

1. **put prefetch** (host -> device): ``take(name, ahead=...)`` returns the
   device tensors of block ``name`` and issues puts for the caller's next
   ``prefetch_depth`` blocks in its own walk order (the backward walk gets
   the same look-ahead as the forward);
2. **fetch queue** (device -> host): ``d2h`` enqueues a block's copies,
   ``submit_fetch`` runs its host work on :data:`TRANSFER_POOL` and blocks
   only while more than ``fetch_window`` are in flight;
3. **persistent staging**: ``stage_grad`` accumulates into per-(block, key)
   host buffers reused across micro-batches and steps, tagged by
   generation (a step's first write overwrites, later writes add);
4. **NVMe state look-ahead**: ``schedule_state_prefetch`` forwards the apply
   order to the store, ``prefetch_depth`` blocks ahead (no-op on the host
   tier).

On the card a put is a ``non_blocking`` copy from pinned host memory on a
dedicated copy stream, with a ``torch.cuda.Event`` recorded after it; the
consumer's stream waits on that event and ``record_stream`` keeps the
caching allocator from reusing the block's memory early. A fetch is a
``non_blocking`` copy on a second copy stream that first waits for the
compute stream; its event is waited on before the host reads the bytes.
On the CPU the copies are plain copies and the fences trivial: the same
class serves both.

Accounting (the JAX contract): DISPATCH is wall time issuing puts, REALIZED
the busy-interval union of fenced transfer spans (k overlapping transfers
count each wall second once), WAIT main-thread blocked time;
``overlap_efficiency = 1 - exposed_wait / realized_transfer``. With
``time_transfers`` set on the card, every put and fetch also records a
pair of timing events around its copies on the copy stream, appended to
``transfer_events`` as ``(kind, bytes, start, end)`` (kind ``"h2d"`` or
``"d2h"``) for the caller to read once they have completed.
"""

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import torch

# host work of fetches (the C optimizer step releases the interpreter
# lock) and host<->device copies; module-level so engines built one after
# another share the threads
TRANSFER_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="memstream-io")

# completion fences only observe (an event's synchronize + a timestamp)
_FENCE_POOL = ThreadPoolExecutor(max_workers=4, thread_name_prefix="memstream-fence")


class LayerStreamExecutor:
    """Bidirectional streaming transfer executor (see the module doc).
    ``dispatch_fn(name)`` returns block ``name``'s device tensors (a dict),
    issued with ``non_blocking`` copies; ``store`` is an optional state
    store with ``schedule_state_prefetch(names)``."""

    def __init__(self, dispatch_fn, store, prefetch_depth, fetch_window, device="cpu"):
        self._dispatch = dispatch_fn
        self._store = store
        self.depth = max(0, int(prefetch_depth))
        self.window = max(1, int(fetch_window))
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._h2d = torch.cuda.Stream(self.device) if cuda else None
        self._d2h = torch.cuda.Stream(self.device) if cuda else None
        self._puts = {}          # name -> (device tensors, event) in flight
        self._put_events = {}    # name -> event of the block's latest put
        self._fetches = deque()  # in-flight fetch futures
        self._fences = []        # put-completion fence futures
        self._grad_stage = {}    # (name, key) -> persistent host accumulator
        self._stage_gen = {}     # (name, key) -> generation last written
        self._gen = 0
        self._lock = threading.Lock()
        self.time_transfers = False
        self.transfer_events = []  # (kind, bytes, start, end) while time_transfers
        self.reset_stats()

    def reset_stats(self):
        self.stats = {"put_dispatch_s": 0.0, "put_wait_s": 0.0, "fetch_wait_s": 0.0, "puts": 0,
                      "puts_prefetched": 0}
        # [accumulated busy, end of the last counted span]
        self._busy = {"put": [0.0, 0.0], "fetch": [0.0, 0.0]}

    def _bump(self, key, dt):
        with self._lock:
            self.stats[key] += dt

    def _bump_busy(self, key, t0, t1):
        """Fold span [t0, t1] into ``key``'s busy-interval union (spans
        arrive roughly in completion order; one ending before the counted
        end lies inside the counted region)."""
        with self._lock:
            acc, last = self._busy[key]
            if t1 > last:
                self._busy[key] = [acc + t1 - max(t0, last), t1]

    def begin_step(self):
        """Join stragglers of an aborted step, reset the step's stats and
        advance the staging generation."""
        while self._fetches:
            try:
                self._fetches.popleft().result()
            except Exception:  # noqa: BLE001 — the aborted step raised it already
                pass
        for f in self._fences:
            f.result()
        self._fences = []
        self._gen += 1
        self.invalidate()
        with self._lock:
            self.reset_stats()

    def invalidate(self):
        """Drop in-flight puts (an aborted walk may strand puts whose host
        sources the applies have since rewritten)."""
        self._puts.clear()

    def collect_stats(self):
        """Join the put fences and return this step's transfer accounting."""
        for f in self._fences:
            f.result()
        self._fences = []
        with self._lock:
            out = dict(self.stats)
            out["put_realized_s"] = self._busy["put"][0]
            out["fetch_realized_s"] = self._busy["fetch"][0]
            return out

    # -- flow 1: host -> device --------------------------------------------
    def _dispatch_timed(self, name):
        t0 = time.perf_counter()
        if self._h2d is None:
            val, ev = self._dispatch(name), None
        else:
            with torch.cuda.stream(self._h2d):
                start = self._timing_start(self._h2d)
                val = self._dispatch(name)
                ev = torch.cuda.Event(enable_timing=start is not None)
                ev.record(self._h2d)
            if start is not None:
                self.transfer_events.append(("h2d", sum(t.nbytes for t in val.values()), start, ev))
        self._bump("put_dispatch_s", time.perf_counter() - t0)
        self._put_events[name] = ev

        def fence():
            if ev is not None:
                ev.synchronize()
            self._bump_busy("put", t0, time.perf_counter())
        f = _FENCE_POOL.submit(fence)
        # eval and generate never collect: prune finished fences
        if len(self._fences) > 256:
            self._fences = [p for p in self._fences if not p.done()]
        self._fences.append(f)
        return val, ev, f

    def prefetch(self, names):
        """Issue puts for ``names`` now (skipping blocks in flight; no-op at
        depth 0)."""
        if self.depth == 0:
            return
        for name in names:
            if name not in self._puts:
                self._puts[name] = self._dispatch_timed(name)

    def take(self, name, ahead=()):
        """Block ``name``'s device tensors, ready for the current stream.
        Issues ``name`` (if cold) and the first ``prefetch_depth`` of
        ``ahead``. At depth 0 the put is fenced at the point of use: compute
        never overlaps a transfer."""
        was_ahead = name in self._puts
        self.prefetch([name])
        self.prefetch(list(ahead)[:self.depth])
        ent = self._puts.pop(name, None)
        t0 = time.perf_counter()
        if ent is None:
            val, ev, fence = self._dispatch_timed(name)
            fence.result()
        else:
            val, ev, _ = ent
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in val.values():
                t.record_stream(cur)
        with self._lock:
            self.stats["put_wait_s"] += time.perf_counter() - t0
            self.stats["puts"] += 1
            self.stats["puts_prefetched"] += was_ahead
        return val

    def wait_put(self, name):
        """Block until the latest put of ``name`` has read its host source
        (the host must not rewrite a pinned source a copy still reads)."""
        ev = self._put_events.get(name)
        if ev is not None:
            ev.synchronize()

    # -- flow 2: bounded-window fetch ----------------------------------------
    def d2h(self, pairs):
        """Enqueue ``dst.copy_(src)`` for each (host dst, device src) pair
        after the work queued so far on the current stream; returns the
        event to wait on before reading the host bytes (None on the CPU,
        where the copies are done on return)."""
        if self._d2h is None:
            for dst, src in pairs:
                dst.copy_(src)
            return None
        self._d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._d2h):
            start = self._timing_start(self._d2h)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
                src.record_stream(self._d2h)
            ev = torch.cuda.Event(enable_timing=start is not None)
            ev.record(self._d2h)
        if start is not None:
            self.transfer_events.append(("d2h", sum(s.nbytes for _, s in pairs), start, ev))
        return ev

    def _timing_start(self, stream):
        """A timing event recorded on ``stream`` now, or None when
        ``time_transfers`` is off."""
        if not self.time_transfers:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def timed_fetch(self, event):
        """Wait for a fetch's event, its span folded into the fetch busy
        union (only the transfer, never the host work after it)."""
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self._bump_busy("fetch", t0, time.perf_counter())

    def submit_fetch(self, fn):
        """Run ``fn`` on the transfer pool; block only while more than
        ``fetch_window`` fetches are in flight."""
        self._fetches.append(TRANSFER_POOL.submit(fn))
        t0 = time.perf_counter()
        while len(self._fetches) > self.window:
            self._fetches.popleft().result()
        self._bump("fetch_wait_s", time.perf_counter() - t0)

    def drain_fetches(self):
        """Block until every in-flight fetch has landed (a raised error
        surfaces here)."""
        t0 = time.perf_counter()
        try:
            while self._fetches:
                self._fetches.popleft().result()
        finally:
            self._bump("fetch_wait_s", time.perf_counter() - t0)

    # -- flow 3: persistent staging ------------------------------------------
    def stage_grad(self, name, key, host, dtype):
        """Accumulate ``host`` into the persistent ``(name, key)`` buffer and
        return it: the step's first write overwrites, later ones add."""
        k = (name, key)
        buf = self._grad_stage.get(k)
        if buf is None or buf.shape != host.shape or buf.dtype != dtype:
            buf = torch.empty(host.shape, dtype=dtype)
            self._grad_stage[k] = buf
            self._stage_gen[k] = -1
        if self._stage_gen[k] != self._gen:
            buf.copy_(host)
            self._stage_gen[k] = self._gen
        else:
            buf.add_(host.to(dtype))
        return buf

    # -- flow 4: NVMe state look-ahead ---------------------------------------
    def schedule_state_prefetch(self, names):
        """Issue state reads for the next blocks of the apply order (no
        store: no-op; depth 0: off like the other flows)."""
        if self.depth and names and self._store is not None:
            self._store.schedule_state_prefetch(list(names)[:self.depth])
