"""The serving replica set, one replica: the scheduler behind the gateway.

Port of ``deepspeed_tpu/serving/replica.py``, its one-replica path. A
:class:`ReplicaSet` fronts the engine's own
:class:`~deepspeed_tpu_torch.inference.scheduler.DecodeScheduler` (so the
gateway drives exactly the scheduler ``engine.scheduler()`` returns) with
the JAX set's placement bookkeeping: ``route`` places a request when the
replica is not draining and has a free slot, ``drain``/``resume`` stop and
restart placement, and ``step`` keeps the replica's throughput EWMA and
its ``serving/replica/<id>/...`` telemetry. Exactly one pump thread calls
:meth:`Replica.step`, so the scheduler stays single-threaded. (The JAX set
marks a failing replica sick only while another stays healthy; with one
replica the gateway fails the in-flight requests and keeps serving.)

More than one replica, disaggregated prefill/decode roles, migration
(``park_out``, handoffs, resumes) and elastic growth are refused with
``NotImplementedError`` naming ROADMAP Queue 1 #9; the port's config
refuses the same sections (``continuous_batching.replicas``,
``disaggregation``, ``autoscaler``).

Telemetry: gauges ``serving/replica/<id>/{slot_occupancy,queue_depth,
tok_s}``; counters ``serving/replica/<id>/{dispatched,tokens}``,
``serving/dispatch/least_loaded``, ``serving/replica_drains``.
"""

import threading
import time

_ITEM9 = "ROADMAP Queue 1 #9, sharded decode and replicas"


def _unported(what):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({_ITEM9})")


class Replica:
    """One scheduler + its bookkeeping (placement load signals, drain
    state, throughput EWMA). Exactly one pump thread calls :meth:`step`."""

    phase_role = "mixed"

    def __init__(self, idx, scheduler, telemetry=None):
        self.idx = idx
        self.scheduler = scheduler
        # request traces stamp the replica that executed each phase
        scheduler.replica_idx = idx
        self.telemetry = telemetry if telemetry is not None else scheduler.telemetry
        self.draining = False
        self.dispatched = 0
        self.tokens = 0
        self.ema_service_s = None   # per-replica service-time EMA
        self.tok_s = 0.0            # EWMA of delivered tokens/sec
        self._last_step_end = None

    # ---------------------------------------------------------------- load
    def busy_slots(self):
        s = self.scheduler
        return s.cache.active_slots + len(s.queue) + (1 if s._prefill is not None else 0)

    def has_capacity(self):
        return self.busy_slots() < self.scheduler.num_slots

    def available(self):
        """Placement-eligible: accepting new work."""
        return not self.draining

    def idle(self):
        s = self.scheduler
        return not (s.active or s.queue or s._prefill is not None)

    # ---------------------------------------------------------------- loop
    def step(self):
        """One scheduler iteration plus throughput accounting. Called ONLY
        from this replica's pump thread."""
        t0 = time.monotonic()
        delivered = self.scheduler.step()
        now = time.monotonic()
        self.tokens += delivered
        # inter-step host overhead counts, but an IDLE gap (pump parked
        # waiting for work) must not: a lull would fold a near-zero sample
        # into the EWMA and understate a lightly-loaded replica
        prev = self._last_step_end
        start = prev if (prev is not None and t0 - prev < 1.0) else t0
        dt = now - start
        self._last_step_end = now
        if dt > 0:
            inst = delivered / dt
            self.tok_s = inst if self.tok_s == 0.0 else 0.9 * self.tok_s + 0.1 * inst
        tel = self.telemetry
        if tel.enabled:
            tel.gauges([
                (f"serving/replica/{self.idx}/slot_occupancy", self.scheduler.cache.occupancy(), None),
                (f"serving/replica/{self.idx}/queue_depth", float(len(self.scheduler.queue)), None),
                (f"serving/replica/{self.idx}/tok_s", self.tok_s, None)])
            if delivered:
                tel.counter(f"serving/replica/{self.idx}/tokens", delivered)
        return delivered

    def observe_service(self, service_s):
        """Fold one naturally-completed request's wall time into the
        service EMA (cancelled/failed requests don't count)."""
        self.ema_service_s = (service_s if self.ema_service_s is None
                              else 0.9 * self.ema_service_s + 0.1 * service_s)

    def state(self):
        s = self.scheduler
        return {
            "idx": self.idx,
            "status": "draining" if self.draining else "active",
            "phase_role": self.phase_role,
            "num_slots": s.num_slots,
            "active_slots": s.cache.active_slots,
            "cached_slots": s.cache.cached_slots,
            "queue_depth": len(s.queue),
            "slot_occupancy": round(s.cache.occupancy(), 4),
            "dispatched": self.dispatched,
            "tokens": self.tokens,
            "tok_s": round(self.tok_s, 2),
            # capacity accounting (telemetry/capacity.py): this pump's
            # host-gap total and goodput
            "goodput_fraction": (round(s.capacity.goodput_fraction, 5)
                                 if s.capacity is not None else None),
            "host_gap_total_s": round(s._gap.total_gap_s, 4) if s._gap is not None else None,
            "ema_service_s": self.ema_service_s,
            "tp_size": s.tp_size,
            "ep_size": s.ep_size,
            "prefix_cache_hit_rate": (round(s.radix.hit_rate(), 4)
                                      if s.radix is not None else None),
            # hierarchical KV tier: this scheduler's demote/restore counts
            # and the host store's residency (memory/kv_tier.py)
            "kv_tier": s.kv_tier.stats() if s.kv_tier is not None else None,
        }


class ReplicaSet:
    """The replica behind the gateway's dispatch policy. Thread-safe: the
    gateway's pump and HTTP threads race :meth:`route`, :meth:`drain` and
    :meth:`resume` under the internal lock; ``step`` stays exclusive to the
    pump."""

    def __init__(self, replicas):
        if len(replicas) != 1:
            raise _unported(f"{len(replicas)} serving replicas (the port serves one)")
        self.replicas = list(replicas)
        self.telemetry = self.replicas[0].telemetry
        self._lock = threading.RLock()

    @classmethod
    def build(cls, engine, n=None, **scheduler_overrides):
        """The replica over ``engine.scheduler(**scheduler_overrides)``, the
        engine's singleton scheduler. ``n`` defaults to the engine's
        ``continuous_batching.replicas``; more than one raises."""
        cb = engine._config.continuous_batching
        if n is None:
            n = int(getattr(cb, "replicas", 1) or 1)
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        if n > 1:
            raise _unported(f"{n} serving replicas (the port serves one)")
        return cls([Replica(0, engine.scheduler(**scheduler_overrides))])

    @property
    def primary(self):
        return self.replicas[0].scheduler

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    # ---------------------------------------------------------------- fleet state
    def any_capacity(self):
        """A fresh prompt can be placed right now."""
        return any(r.available() and r.has_capacity() for r in self.replicas)

    def states(self):
        return [r.state() for r in self.replicas]

    # ---------------------------------------------------------------- lifecycle
    def drain(self, idx):
        """Stop placing onto replica ``idx``; in-flight work finishes.
        Idempotent; resumable."""
        with self._lock:
            rep = self.replicas[idx]
            rep.draining = True
        if self.telemetry.enabled:
            self.telemetry.counter("serving/replica_drains")
        return rep.state()

    def resume(self, idx):
        """Re-admit replica ``idx`` to placement."""
        with self._lock:
            rep = self.replicas[idx]
            rep.draining = False
        return rep.state()

    def set_role(self, idx, role):
        raise _unported("phase roles (disaggregated prefill/decode)")

    def add_replica(self, phase_role="mixed"):
        raise _unported("elastic replica growth")

    def park_out(self, rep, req):
        raise _unported("request migration (park_out)")

    def inject_resume(self, desc, on_token=None, trace=None, collect_logits=False):
        raise _unported("migration resume")

    # ---------------------------------------------------------------- dispatch
    def route(self, prompt, adapter=None):
        """The replica to place ``prompt`` on, or None when it is not
        available or has no free slot."""
        with self._lock:
            rep = self.replicas[0]
            if not (rep.available() and rep.has_capacity()):
                return None
            if self.telemetry.enabled:
                self.telemetry.counter("serving/dispatch/least_loaded")
            return rep

    def note_dispatch(self, rep):
        """Account one placement on ``rep`` (after a successful submit)."""
        rep.dispatched += 1
        if self.telemetry.enabled:
            self.telemetry.counter(f"serving/replica/{rep.idx}/dispatched")
