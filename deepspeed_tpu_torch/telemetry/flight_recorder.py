"""Anomaly flight recorder: a cheap always-on ring of recent events.

Production serving failures are diagnosed from what happened in the seconds
AROUND an anomaly — a deadline-expiry storm, a backend error, an SLO burn-rate trip — but the JSONL stream is sampled
(histograms summarize at flush) and the Perfetto trace is capped. The
flight recorder keeps the last ``capacity`` events at FULL resolution
(every span/gauge/counter/histogram observation as a compact tuple) in a
bounded ring; a trigger snapshots the ring (the iterations *preceding* the
anomaly), keeps collecting for ``post_window_s`` (the iterations
*following* it), then writes one self-contained JSON dump under the sink's
output path.

Triggers (all route through :meth:`TelemetrySink.dump_flight`):

- SLO burn-rate alert (``telemetry/slo.py`` -> the gateway's alert hook)
- scheduler/backend step failure (``serving/gateway.py`` pump)
- ``SIGUSR1`` (``python -m deepspeed_tpu_torch.serving`` installs the handler)
- ``GET /v1/debug/flight`` (operator-forced dump)

Recording cost is one deque append per event — the ring only exists when
the sink is enabled, so the default-off hot path is untouched.

A copy of ``deepspeed_tpu/telemetry/flight_recorder.py`` (stdlib only)
without its recompile trigger: the port runs eagerly and compiles no
programs.
"""

import json
import os
from collections import deque


class FlightRecorder:
    """Bounded full-resolution event ring + dump lifecycle.

    Ring/pending mutation happens under the owning sink's lock (the sink
    calls :meth:`record`/:meth:`trigger`/:meth:`take_ready` from its
    producer paths); the file write (:meth:`write_dump`) takes only local
    state, so the sink runs it OUTSIDE the producer lock.
    """

    __slots__ = ("capacity", "post_window_s", "min_interval_s", "_ring",
                 "_pending", "_last_trigger_ts", "_seq", "dumps")

    def __init__(self, capacity=8192, post_window_s=0.25, min_interval_s=1.0):
        self.capacity = max(64, int(capacity))
        self.post_window_s = max(0.0, float(post_window_s))
        self.min_interval_s = max(0.0, float(min_interval_s))
        self._ring = deque(maxlen=self.capacity)
        self._pending = []        # dumps still collecting their post-window
        self._last_trigger_ts = None
        self._seq = 0
        self.dumps = []           # paths written this process

    def record(self, ts, kind, name, value, attrs=None, track=None):
        """One event into the ring (and into any dump still collecting its
        post-window). Compact list form keeps the ring cheap to append and
        the dump file grep-able."""
        if track is not None:
            attrs = dict(attrs or (), track=track)
        ev = [round(ts, 6), kind, name, value] + ([attrs] if attrs else [])
        self._ring.append(ev)
        for pending in self._pending:
            pending["events_after"].append(ev)

    def trigger(self, sink, reason, attrs=None):
        """Snapshot the ring now; the dump is finalized once the post-window
        elapses (:meth:`take_ready`, driven by the sink's flush path) or at
        sink close. Rate-limited: triggers inside ``min_interval_s`` of the
        previous one are dropped (an alert storm must not turn the recorder
        into a disk-filling anomaly of its own). Returns the dump path or
        None."""
        now = sink.now()
        if (self._last_trigger_ts is not None
                and now - self._last_trigger_ts < self.min_interval_s):
            return None
        self._last_trigger_ts = now
        self._seq += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in str(reason))
        path = os.path.join(sink.output_path, f"flight_{self._seq:03d}_{safe}.json")
        self._pending.append({
            "reason": str(reason), "attrs": attrs or {},
            "trigger_ts": round(now, 6), "started_at": sink.started_at,
            "post_window_s": self.post_window_s, "path": path,
            "event_format": ["ts", "kind", "name", "value", "attrs?"],
            "events_before": list(self._ring), "events_after": [],
            "deadline": now + self.post_window_s,
        })
        return path

    def take_ready(self, now, force=False):
        """Pop dumps whose post-window has elapsed (all of them when
        ``force``, e.g. at sink close — a truncated post-window beats a lost
        dump). Call under the sink lock; pass the result to
        :meth:`write_dump` outside it."""
        if not self._pending:
            return []
        ready = [p for p in self._pending if force or now >= p["deadline"]]
        self._pending = [p for p in self._pending if p not in ready]
        return ready

    def write_dump(self, pending):
        """Write one dump document (atomic rename); safe outside any lock."""
        path = pending.pop("path")
        pending.pop("deadline", None)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(pending, f)
            os.replace(tmp, path)
            self.dumps.append(path)
        except OSError:  # a full disk must not take the serving process down
            pass
        return path
