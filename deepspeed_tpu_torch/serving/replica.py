"""The serving fleet: N decode schedulers behind one dispatch policy.

Port of ``deepspeed_tpu/serving/replica.py`` without its elastic part. A
:class:`ReplicaSet` fronts N
:class:`~deepspeed_tpu_torch.inference.scheduler.DecodeScheduler` replicas
over ONE engine: one weight tree (every replica's forwards read the
engine's parameters), one host prefix store (threaded through the
scheduler's ``_init_kwargs``), N slot pools and N decode loops. Replica 0
is the engine's own scheduler, so a one-replica fleet is the engine's path
unchanged.

Dispatch (the gateway's fair queue pops in DRR order, then this layer
places):

- **Prefix-sticky**: a prompt whose leading ``prefill_chunk`` tokens match
  a prompt placed before goes to the replica that took that one (its radix
  trie holds the prefix). The index is a bounded LRU on the host, keyed on
  the leading chunk, re-pointed wherever placement lands.
- **Least-loaded** otherwise: the least ``(busy slots + 1) x service-time
  EMA / slots``, ties broken round-robin so an idle fleet spreads.

Placement never changes a stream: a draw depends on the request's seed,
its absolute step and the vocab index only.

Lifecycle: ``drain(i)`` stops placement (in-flight work finishes;
``resume(i)`` re-admits); a replica whose step raises is marked sick (its
requests fail, its sticky entries purge, the rest of the fleet serves).

**Disaggregated prefill/decode** (``continuous_batching.disaggregation``,
DistServe/Splitwise): replicas carry a phase role, ``prefill``,
``decode`` or ``mixed`` (the default; a fleet of mixed replicas never
migrates). Placement considers prefill-capable replicas only. When a
prompt's chunked prefill completes on a ``prefill`` replica, the
scheduler's migrate hook (:meth:`ReplicaSet._maybe_migrate`) demotes the
request's whole KV through the shared host store
(``memory/kv_tier.KVTier.demote_request``) and parks it in the fleet's
migration queue; decode-capable replicas PULL from it as their pumps find
capacity (:meth:`ReplicaSet.admit_migrations`), so a parked handoff is
bound to no replica and any healthy decode replica adopts it. Decode
resumes bitwise: the KV rows move byte for byte (int8 row scales with
them) and the request object travels as it is. ``migrate_min_tokens``
keeps short prompts where they prefilled; a fleet whose decode side is
gone colocates rather than stall.

**Across ranks** (a world of more than one, every rank holding the same
engine over its tensor, expert or seq shard): every rank builds the same
fleet, and each replica gets a scope of process groups of its own
(``comm.build_group_scope``, at build time, on every rank), which
:meth:`Replica.step` enters, so two replicas stepping at once never
interleave collectives on one group. Under the gateway, rank 0 serves and
the other ranks follow (:meth:`Replica.follow`): before each step of a
replica, rank 0 sends the scheduler calls it made since that replica's
last step (submits with their rid and every sampling argument, cancels) in
one all-gather on the replica's scope, and every rank applies them in
order and steps. The all-gather also carries each rank's step count and
the tokens its last step delivered (ranks that differ raise on every rank
at once, "ranks diverged") and the requests rank 0's step will run on: a
follower whose own differ after the calls raises before it steps, since
a step that differs would wait in a collective rank 0 never joins. A rank
that raises does not go on.

**Across processes** (the multi-host router, ``serving/router.py``): a
prefill worker's handoff is resumed in another process by
:meth:`ReplicaSet.inject_resume`, which parks the rebuilt request as a
ready handoff whose entry lives in the owner's networked store shard.

Not ported, each raising ``NotImplementedError``: phase roles at a world
above one rank (``#9.1, its leftover``), cross-process resumes at a world
above one rank (``#9.2, its leftover``), and the elastic controller's
growth, scale-down and brownout parking (#9.5).

Telemetry: gauges ``serving/replica/<id>/{slot_occupancy,queue_depth,
tok_s}``; counters ``serving/replica/<id>/{dispatched,tokens,
migrations_out,migrations_in}``, ``serving/dispatch/{sticky,least_loaded}``,
``serving/replica_sick``, ``serving/replica_drains``,
``serving/migrations``, ``serving/migration_tokens``; histogram
``serving/migration_ms``.
"""

import collections
import contextlib
import threading
import time

import numpy as np

from .. import comm as dist

# handoff-key sentinel: negative (never a real token); a handoff keys as
# (_MIG_SENTINEL, unique counter), so no probe of prompt tokens matches one
_MIG_SENTINEL = -(1 << 30)

_PHASE_ROLES = ("prefill", "decode", "mixed")

# the groups a replica's forwards may use across ranks: every rank (the
# lockstep exchange) and the tensor, expert and seq axes
_SERVING_GROUPS = (None, dist.TENSOR_AXIS, dist.EXPERT_AXIS, dist.SEQ_AXIS)

# rank 0 exchanges with an idle replica's followers at least this often, so
# their wait never reaches the process group's timeout
KEEPALIVE_S = 10.0

_ELASTIC = "ROADMAP Queue 1 #9.5, the elastic controller"
_ROUTER_LEFTOVER = "ROADMAP Queue 1 #9.2, its leftover"


def _unported(what, item):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({item})")


class _Migration:
    """One prefill-to-decode handoff in flight: the request and where its
    KV is parked. ``entry`` stays None until the demote's fetch lands
    (``ready`` flips then); decode pumps only take ready records."""

    __slots__ = ("req", "key", "kv_len", "version", "entry", "ready", "src_idx", "t_start")

    def __init__(self, req, key, src_idx, t_start):
        self.req = req
        self.key = key
        self.kv_len = 0
        self.version = 0
        self.entry = None
        self.ready = False
        self.src_idx = src_idx
        self.t_start = t_start


class _FleetPump:
    """The handle's pump while its request is parked: ``result()`` must
    drive the whole fleet (the prefill scheduler alone would spin), so
    migrate-out points the handle here until a decode replica adopts it."""

    __slots__ = ("_rs", "engine")

    def __init__(self, rs):
        self._rs = rs
        self.engine = rs.primary.engine

    def step(self):
        return self._rs.pump_once()


class Replica:
    """One scheduler and its fleet bookkeeping (load signals, health and
    drain state, phase role, throughput EWMA). Exactly one pump thread
    calls :meth:`step`; under the gateway the other threads' submits wait
    for it too (:meth:`turn`), so every call into a scheduler is its own
    pump's."""

    def __init__(self, idx, scheduler, telemetry=None, phase_role="mixed", scope=None):
        self.idx = idx
        self.scheduler = scheduler
        # request traces stamp the replica that executed each phase
        scheduler.replica_idx = idx
        self.telemetry = telemetry if telemetry is not None else scheduler.telemetry
        self.draining = False
        self.sick = False
        self.sick_error = None
        self.dispatched = 0
        self.tokens = 0
        self.phase_role = phase_role
        self.ema_service_s = None   # per-replica service-time EMA
        self.tok_s = 0.0            # EWMA of delivered tokens/sec
        self._last_step_end = None
        # across ranks: this replica's group scope. Under a gateway pump
        # (``pumped``) the calls other threads make wait in _calls for this
        # replica's pump (and, across ranks, go to the followers with it)
        self.scope = scope
        self.pumped = False
        # one step at a time in a process: the fleet's (ReplicaSet)
        self.step_lock = contextlib.nullcontext()
        self._calls = []
        self._call_lock = threading.Lock()
        self._steps = 0
        self._last_delivered = 0
        self._last_exchange = time.monotonic()

    # ---------------------------------------------------------------- phase
    def prefill_capable(self):
        """Eligible for fresh placement."""
        return self.phase_role in ("prefill", "mixed")

    def decode_capable(self):
        """Eligible to adopt migrated decode work."""
        return self.phase_role in ("decode", "mixed")

    # ---------------------------------------------------------------- load
    def busy_slots(self):
        s = self.scheduler
        return (s.cache.active_slots + len(s.queue) + (1 if s._prefill is not None else 0)
                + sum(1 for c in self._calls if c[0] == "submit"))

    def has_capacity(self):
        return self.busy_slots() < self.scheduler.num_slots

    def available(self):
        """Placement-eligible: healthy and accepting new work."""
        return not (self.sick or self.draining)

    def idle(self):
        s = self.scheduler
        return not (s.active or s.queue or s._prefill is not None)

    def expected_drain_s(self, fallback_ema):
        """Placement score: the expected time for this replica's backlog
        and the incoming request to clear at its measured service rate."""
        ema = self.ema_service_s if self.ema_service_s is not None else fallback_ema
        return (self.busy_slots() + 1) * ema / max(1, self.scheduler.num_slots)

    # ---------------------------------------------------------------- loop
    def step(self):
        """One scheduler iteration (its collectives on this replica's group
        scope) plus throughput accounting. Called ONLY from this replica's
        pump thread."""
        t0 = time.monotonic()
        with self.step_lock, dist.group_scope(self.scope):
            delivered = self.scheduler.step()
        now = time.monotonic()
        self._steps += 1
        self._last_delivered = delivered
        self.tokens += delivered
        # inter-step host overhead counts, but an idle gap (the pump parked
        # waiting for work) must not fold a near-zero sample into the EWMA
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
        placement EMA (cancelled and failed requests don't count)."""
        self.ema_service_s = (service_s if self.ema_service_s is None
                              else 0.9 * self.ema_service_s + 0.1 * service_s)

    # ---------------------------------------------------------------- calls
    def submit(self, prompt, **kwargs):
        """``scheduler.submit``. Under a gateway pump (``pumped``) the
        request is made and checked now, and queued by this replica's own
        pump at its next :meth:`turn` (across ranks, on every rank)."""
        if not self.pumped:
            return self.scheduler.submit(prompt, **kwargs)
        wire = {k: v for k, v in kwargs.items() if k not in ("on_token", "trace")}
        with self._call_lock:
            req = self.scheduler._make_request(prompt, **kwargs)
            if not req.done:
                self._calls.append(("submit", req, wire))
        return req.handle

    def cancel(self, handle):
        """``handle.cancel()``; across ranks, at this replica's next turn on
        every rank."""
        if self.scope is None:
            handle.cancel()
            return
        with self._call_lock:
            self._calls.append(("cancel", handle._req, None))

    def flush_radix(self):
        """Evict the whole radix trie through the KV tier (each eviction
        demotes to the host store) and join the demotes, so they are
        probe-visible; across ranks, at the next turn on every rank. On the
        replica's own pump thread."""
        if self.scope is None:
            self._flush_now()
            return
        with self._call_lock:
            self._calls.append(("flush", None, None))

    def _flush_now(self):
        sched = self.scheduler
        if sched.radix is not None:
            while True:
                victim = sched.radix.evict_lru()
                if victim is None:
                    break
                sched.cache.reclaim(victim)
        if sched.kv_tier is not None:
            sched.kv_tier.executor.drain_fetches()

    def _live(self):
        """What the next step will run on: every request the scheduler
        holds, as (rid, tokens so far, cancelled)."""
        s = self.scheduler
        live = list(s.active.values()) + list(s.queue) + ([s._prefill.req] if s._prefill is not None else [])
        return sorted((r.rid, len(r.out), bool(r.cancelled)) for r in live)

    def _exchange(self, payload):
        """One lockstep exchange on this replica's scope: rank 0's payload,
        and every rank's step count and the tokens its last step delivered.
        Raises on every rank when those differ. Returns rank 0's payload."""
        mine = (payload, self._steps, self._last_delivered)
        with dist.group_scope(self.scope):
            got = dist.all_gather_object(mine)
        self._last_exchange = time.monotonic()
        counts = [(g[1], g[2]) for g in got]
        if len(set(counts)) > 1:
            raise RuntimeError(f"replica {self.idx}: ranks diverged: (steps, tokens delivered by the last step) "
                               f"per rank {counts}; rank {dist.get_rank()} stops")
        return got[0][0]

    def turn(self, stop=False):
        """The pump, before a step: apply the calls made since the last
        turn, in order. Across ranks (rank 0) it then sends them to the
        followers with what the step will run on; an idle replica with
        nothing to send exchanges only for the keepalive or ``stop``.
        Returns whether the replica has work to step."""
        with self._call_lock:
            calls, self._calls = self._calls, []
        for op, req, _ in calls:
            if op == "submit":
                self.scheduler._enqueue(req)
            elif op == "cancel":
                req.cancelled = True
            else:
                self._flush_now()
        if self.scope is not None and (calls or stop or not self.idle()
                                       or time.monotonic() - self._last_exchange >= KEEPALIVE_S):
            wire = [(op, None if req is None else req.rid, None if w is None else (req.prompt.tolist(), w))
                    for op, req, w in calls]
            self._exchange((wire, stop, self._live()))
        return not stop and not self.idle()

    def follow(self):
        """A following rank's loop for this replica: take each turn's calls
        from rank 0, apply them in order, and check that the step will run
        on what rank 0's will (else raise before stepping: a step that
        differs would wait in a collective rank 0 never joins); step when
        rank 0 steps; return at rank 0's stop."""
        reqs = {}
        while True:
            calls, stop, live = self._exchange(None)
            for call in calls:
                self._apply(reqs, call)
            if self._live() != live:
                raise RuntimeError(f"replica {self.idx}: ranks diverged: rank {dist.get_rank()} would step on "
                                   f"(rid, tokens, cancelled) {self._live()}, rank 0 on {live}; it stops")
            if stop:
                return
            if not self.idle():
                self.step()
                if len(reqs) > 4 * self.scheduler.num_slots:
                    reqs = {rid: r for rid, r in reqs.items() if not r.done}

    def _apply(self, reqs, call):
        """One of rank 0's calls on a following rank."""
        op, rid, payload = call
        sched = self.scheduler
        if op == "submit":
            prompt, wire = payload
            req = sched._make_request(np.asarray(prompt, np.int32), rid=rid, **wire)
            reqs[rid] = req
            if not req.done:
                sched._enqueue(req)
        elif op == "cancel":
            if rid in reqs:
                reqs[rid].cancelled = True
        else:
            self._flush_now()

    def state(self):
        s = self.scheduler
        return {
            "idx": self.idx,
            "status": "sick" if self.sick else "draining" if self.draining else "active",
            "error": self.sick_error,
            "phase_role": self.phase_role,
            "migrations_out": s.migrations_out,
            "migrations_in": s.migrations_in,
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
            # and the fleet-shared host store's residency
            "kv_tier": s.kv_tier.stats() if s.kv_tier is not None else None,
        }


class ReplicaSet:
    """N replicas behind one dispatch policy. Thread-safe: the gateway's
    pump and HTTP threads race :meth:`route`, :meth:`drain`,
    :meth:`set_role` and the migration queue under the internal lock; each
    replica's ``step`` stays exclusive to its own pump."""

    # the gateway's wakeup for parked decode pumps (None: direct callers
    # poll through pump_once)
    on_migration_ready = None

    def __init__(self, replicas, sticky_capacity=2048, roles=None, migrate_min_tokens=0):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self.replicas = list(replicas)
        self.telemetry = self.replicas[0].telemetry
        self._lock = threading.RLock()
        if self.replicas[0].scope is None:
            # pump threads take turns at whole steps: a step is host-bound
            # (it enqueues its kernels from Python), and two interleaved
            # would hand the interpreter lock back and forth at every torch
            # call. Across ranks the replicas' steps stay concurrent: a lock
            # taken in another order on each rank would deadlock their
            # collectives
            lock = threading.Lock()
            for rep in self.replicas:
                rep.step_lock = lock
        self._rr = 0  # round-robin tie-break cursor
        # sticky prefix index: leading-chunk key -> replica idx (bounded LRU)
        self._sticky = collections.OrderedDict()
        self._sticky_capacity = int(sticky_capacity)
        chunk = self.primary.prefill_chunk
        self._sticky_chunk = chunk if chunk > 0 else 64
        # disaggregated prefill/decode: the fleet's handoff queue (decode
        # pumps pull ready records) and the migrate-time knobs; the hooks
        # install the first time a replica takes a non-mixed role
        self._migrations = collections.deque()
        self._mig_id = 0
        self.migrate_min_tokens = max(0, int(migrate_min_tokens))
        self.migrations_failed = 0
        self._pump_proxy = _FleetPump(self)
        self._hooks_installed = False
        self._warmup_pending = False
        if roles:
            for idx, role in enumerate(roles):
                if idx < len(self.replicas):
                    self.set_role(idx, role)
            # no pump runs yet: warm the tier's staging here
            self._run_pending_warmup(self.replicas[0])

    @classmethod
    def build(cls, engine, n=None, **scheduler_overrides):
        """N replicas over one engine: replica 0 is the engine's singleton
        scheduler, the siblings clone its exact configuration (and so share
        its prefix store) over the same weight tree. ``n`` defaults to
        ``continuous_batching.replicas``; the ``disaggregation`` section
        seeds the phase roles. Across ranks every rank builds the same
        fleet (collectively: each replica's group scope)."""
        from ..inference.scheduler import DecodeScheduler
        cb = engine._config.continuous_batching
        if n is None:
            n = int(getattr(cb, "replicas", 1) or 1)
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        primary = engine.scheduler(**scheduler_overrides)
        scheds = [primary] + [DecodeScheduler(engine, **primary._init_kwargs) for _ in range(1, n)]
        if primary._fused_block:
            engine._fast_tree()  # the fused kernels' operands, made once for every replica
        scopes = [None] * n
        if dist.is_initialized() and dist.get_world_size() > 1:
            for i in range(n):
                scopes[i] = f"replica{i}"
                dist.build_group_scope(scopes[i], _SERVING_GROUPS)
        dg = cb.disaggregation
        roles = list(dg.roles or []) if dg.enabled else []
        mmt = int(dg.migrate_min_tokens or 0) if dg.enabled else 0
        return cls([Replica(i, s, scope=scopes[i]) for i, s in enumerate(scheds)],
                   roles=roles, migrate_min_tokens=mmt)

    @property
    def primary(self):
        return self.replicas[0].scheduler

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    # ---------------------------------------------------------------- fleet state
    def total_slots(self):
        """Slots across placement-eligible replicas (the Retry-After
        backlog math divides by this)."""
        return (sum(r.scheduler.num_slots for r in self.replicas if r.available())
                or self.primary.num_slots)

    def phase_slots(self, phase):
        """Available slots on one side of the phase split (mixed counts for
        both)."""
        want = Replica.prefill_capable if phase == "prefill" else Replica.decode_capable
        return sum(r.scheduler.num_slots for r in self.replicas if r.available() and want(r))

    def disaggregated(self):
        """Any non-mixed role in the fleet."""
        return any(r.phase_role != "mixed" for r in self.replicas)

    def any_capacity(self):
        """A fresh prompt can be placed now: an available prefill-capable
        replica has a free slot."""
        return any(r.available() and r.has_capacity() and r.prefill_capable()
                   for r in self.replicas)

    def healthy(self):
        return [r for r in self.replicas if not r.sick]

    def all_sick(self):
        return all(r.sick for r in self.replicas)

    def states(self):
        return [r.state() for r in self.replicas]

    # ---------------------------------------------------------------- lifecycle
    def drain(self, idx):
        """Stop placing onto replica ``idx``; in-flight work finishes.
        Idempotent; resumable."""
        with self._lock:
            rep = self.replicas[idx]
            rep.draining = True
            self._purge_sticky(idx)
        if self.telemetry.enabled:
            self.telemetry.counter("serving/replica_drains")
        return rep.state()

    def resume(self, idx):
        """Re-admit replica ``idx`` (clears drain and sick: the operator
        asserting it recovered)."""
        with self._lock:
            rep = self.replicas[idx]
            rep.draining = False
            rep.sick = False
            rep.sick_error = None
        return rep.state()

    def mark_sick(self, idx, error):
        """Health-out replica ``idx`` (its step raised): no more placement,
        its sticky entries purge. Idempotent."""
        with self._lock:
            rep = self.replicas[idx]
            if rep.sick:
                return
            rep.sick = True
            rep.sick_error = str(error)[:500]
            self._purge_sticky(idx)
        if self.telemetry.enabled:
            self.telemetry.counter("serving/replica_sick")

    def _purge_sticky(self, idx):
        for key in [k for k, v in self._sticky.items() if v == idx]:
            del self._sticky[key]

    def add_replica(self, phase_role="mixed"):
        raise _unported("elastic replica growth (add_replica)", _ELASTIC)

    def begin_scale_down(self, idx):
        raise _unported("elastic scale-down", _ELASTIC)

    finish_scale_down = begin_scale_down

    def park_out(self, rep, req):
        raise _unported("brownout parking (park_out)", _ELASTIC)

    release_parked = park_out

    def inject_resume(self, desc, on_token=None, trace=None, collect_logits=False):
        """Cross-process migration, decode side (the multi-host router's
        resume, ``serving/router.py``): rebuild the request a prefill
        WORKER handed off from its descriptor (prompt, sampling arguments,
        the tokens already decoded, where the KV is parked) and park it in
        this fleet's migration queue as a ready record whose entry is a
        :class:`~deepspeed_tpu_torch.memory.net_store.RemoteEntry`.
        :meth:`admit_migrations` then adopts it through the in-process path:
        ``admit_migration`` restores the KV (the NetPrefixStore fetches the
        bytes from the owner over HTTP) and decode resumes bitwise, since a
        draw folds the request's seed and its absolute step ``len(out)``,
        and the rebuilt request carries both and the same budget rounding.
        Returns the request's handle (fleet-pumped until adoption). Raises
        ValueError on a descriptor this fleet cannot honour."""
        from ..inference.scheduler import SchedulerHandle, _Request, _round_up
        from ..memory.net_store import RemoteEntry
        if self.replicas[0].scope is not None:
            raise _unported("cross-process migration resumes across ranks", _ROUTER_LEFTOVER)
        if desc.get("adapter_id") is not None:
            raise ValueError("cross-process resume does not carry adapter page pins; route adapter "
                             "traffic to a worker with the adapter resident instead")
        sched = self.primary
        if sched.kv_tier is None:
            raise ValueError("resume requires the hierarchical KV tier as the migration transport "
                             "(continuous_batching.disaggregation or hierarchical_kv)")
        with self._lock:
            self._mig_id += 1
            rid = -self._mig_id  # never collides with submit()'s own rids
        req = _Request(rid, np.asarray(desc["prompt"], np.int32), int(desc["max_new_tokens"]),
                       desc.get("eos_token_id"), bool(desc.get("do_sample", False)),
                       float(desc.get("temperature", 1.0)), int(desc.get("top_k", 0)),
                       float(desc.get("top_p", 1.0)), int(desc.get("seed", 0)), bool(collect_logits),
                       on_token=on_token, trace=trace)
        # the tokens the prefill side's final sync already decoded (and
        # streamed): their rows are in the KV, and the next draw's absolute
        # step is len(out)
        req.out = [int(t) for t in desc.get("done_tokens", ())]
        if len(req.out) >= req.max_new_tokens:
            raise ValueError("resume descriptor is already complete")
        req.migrating = True
        # submit()'s overshoot rounding: admission sizes extent chains by it
        budget = _round_up(req.max_new_tokens, sched.steps_per_sync)
        if sched.spec_tokens > 0:
            budget = max(budget, req.max_new_tokens + sched._spec_width - 1)
        req.row_budget = int(budget)
        req.handle = SchedulerHandle(self._pump_proxy, req)
        key = tuple(int(t) for t in desc["key"])
        record = _Migration(req, key, None, time.monotonic())
        record.kv_len = int(desc["kv_len"])
        record.version = int(desc["version"])
        record.entry = RemoteEntry(key, record.kv_len, record.version, int(desc.get("nbytes", 0)), True,
                                   desc["owner_url"], desc.get("owner_wid"))
        record.ready = True
        with self._lock:
            self._migrations.append(record)
        if self.telemetry.enabled:
            self.telemetry.counter("serving/migrations")
        cb = self.on_migration_ready
        if cb is not None:
            cb()
        return req.handle

    # ---------------------------------------------------------------- phase roles
    def set_role(self, idx, role):
        """Give replica ``idx`` a phase role (the config's roles and ``POST
        /v1/replicas/<i>/role``). A non-mixed role needs the migration
        transport (the host prefix store) and a fleet that keeps both phases
        coverable; a violation reverts and raises ``ValueError``."""
        if role not in _PHASE_ROLES:
            raise ValueError(f"phase_role must be one of {_PHASE_ROLES}, got {role!r}")
        rep = self.replicas[idx]
        if role != "mixed" and self.replicas[0].scope is not None:
            raise _unported("phase roles across ranks (mirroring the migration pulls on every rank)",
                            "ROADMAP Queue 1 #9.1, its leftover")
        if role != "mixed" and self.primary.kv_tier is None:
            raise ValueError("phase roles need the hierarchical-KV prefix store as the migration "
                             "transport: enable continuous_batching.disaggregation (or "
                             "hierarchical_kv) so the fleet shares one GlobalPrefixStore")
        prev, rep.phase_role = rep.phase_role, role
        if not (any(r.prefill_capable() for r in self.replicas)
                and any(r.decode_capable() for r in self.replicas)):
            rep.phase_role = prev
            raise ValueError(
                f"role {role!r} on replica {idx} would leave the fleet with no "
                f"{'prefill' if role == 'decode' else 'decode'}-capable replica "
                f"(roles: {[r.phase_role for r in self.replicas]})")
        if role == "decode":
            with self._lock:
                self._purge_sticky(idx)  # no fresh placement lands here
        if role != "mixed" and not self._hooks_installed:
            try:
                self._install_migration_hooks()
            except Exception:
                rep.phase_role = prev
                raise
        return rep.state()

    def _install_migration_hooks(self):
        """The first non-mixed role: every scheduler gets the migrate hook
        (it reads the CURRENT role at each prefill completion, so a role
        flip takes effect at once) and the tier's staging warmup is flagged
        for replica 0's pump (a role set from the HTTP thread must not touch
        a pool a pump is writing)."""
        if self.primary.prefill_chunk <= 0:
            raise ValueError("disaggregated serving requires chunked prefill (prefill_chunk > 0): "
                             "migration hands off at chunk-prefill completion")
        for rep in self.replicas:
            rep.scheduler.migrate_hook = self._maybe_migrate
        self._warmup_pending = True
        self._hooks_installed = True

    def _run_pending_warmup(self, rep):
        if self._warmup_pending and rep is self.replicas[0]:
            self._warmup_pending = False
            self.primary.kv_tier.warmup()

    # ---------------------------------------------------------------- migration
    def _maybe_migrate(self, sched, req):
        """The schedulers' migrate hook: hand the request a prefill just
        finished to the decode side when its replica is a ``prefill`` one,
        the prompt is long enough and a decode replica is available. Runs
        on the prefill replica's pump thread. Returns True when taken."""
        rep = next((r for r in self.replicas if r.scheduler is sched), None)
        if rep is None or rep.phase_role != "prefill":
            return False
        if req.prompt.size < self.migrate_min_tokens:
            return False  # colocate: not worth the round trip
        with self._lock:
            if not any(r.decode_capable() and r.available() for r in self.replicas if r is not rep):
                return False  # degraded fleet: colocate rather than stall
            self._mig_id += 1
            key = (_MIG_SENTINEL, self._mig_id)
        record = _Migration(req, key, rep.idx, time.monotonic())
        record.version = int(sched.cache.weights_version)

        def on_ready(entry):
            # the transfer thread: the handoff entry is probe-visible (None:
            # the fetch failed, settled at the next pull); ready flips last
            record.entry = entry
            record.ready = True
            cb = self.on_migration_ready
            if cb is not None:
                cb()
        record.kv_len = sched.migrate_out(req, key, on_ready)
        if req.handle is not None:
            req.handle._sched = self._pump_proxy
        with self._lock:
            self._migrations.append(record)
        tel = self.telemetry
        if tel.enabled:
            tel.counter("serving/migrations")
            tel.counter(f"serving/replica/{rep.idx}/migrations_out")
        return True

    def pending_migrations(self):
        return len(self._migrations)

    def admit_migrations(self, rep):
        """Let ``rep``'s pump claim parked handoffs (from that pump's
        thread, once per turn): cancelled or failed records settle on any
        pump; ready records go to an available decode-capable replica, or
        to any available replica when the decode side is gone. Returns the
        records consumed."""
        self._run_pending_warmup(rep)
        if not self._migrations:
            return 0
        sched = rep.scheduler
        consumed = 0
        while True:
            record, settle = None, False
            with self._lock:
                no_decode_side = not any(r.decode_capable() and r.available() for r in self.replicas)
                can_admit = rep.available() and (rep.decode_capable() or no_decode_side)
                for i, rec in enumerate(self._migrations):
                    # settle READY records only: a cancel racing the demote's
                    # fetch waits for its store put, or the late entry leaks
                    if rec.ready and (rec.req.cancelled or rec.entry is None):
                        record, settle = rec, True
                        del self._migrations[i]
                        break
                    if rec.ready and can_admit and not rec.req.cancelled:
                        record = rec
                        del self._migrations[i]
                        break
                if record is None:
                    return consumed
            if settle:
                sched.admit_migration(record)  # settles without a slot
                if not record.req.cancelled:
                    self.migrations_failed += 1
                consumed += 1
                continue
            try:
                outcome = sched.admit_migration(record)
            except Exception:
                self.migrations_failed += 1
                raise
            if outcome == "resumed":
                consumed += 1
                rep.dispatched += 1
                tel = self.telemetry
                if tel.enabled:
                    tel.counter(f"serving/replica/{rep.idx}/migrations_in")
                    tel.counter("serving/migration_tokens", record.kv_len)
                    tel.histogram("serving/migration_ms", (time.monotonic() - record.t_start) * 1e3)
            elif outcome == "settled":
                self.migrations_failed += 1
                consumed += 1
            else:  # no free slot here: park it again
                with self._lock:
                    self._migrations.appendleft(record)
                return consumed

    def _fail_handoffs(self):
        """No replica can adopt the parked handoffs (the fleet is sick or
        unavailable): settle them as failed. In-flight demote fetches are
        joined first so their entries land and can be dropped."""
        for rep in self.replicas:
            if rep.scheduler.kv_tier is not None:
                rep.scheduler.kv_tier.executor.drain_fetches()
        with self._lock:
            records, self._migrations = list(self._migrations), collections.deque()
        for rec in records:
            self.primary._settle_migration(rec, error="migration failed: no serving replica available")
            if not rec.req.cancelled:
                self.migrations_failed += 1
        return len(records)

    # ---------------------------------------------------------------- dispatch
    def _sticky_key(self, prompt):
        p = np.asarray(prompt, np.int32).reshape(-1)
        return p[:self._sticky_chunk].tobytes()

    def route(self, prompt, adapter=None):
        """The replica to place ``prompt`` on, or None when no eligible
        replica has a free slot: sticky first, least-loaded otherwise; the
        sticky index re-points to wherever placement lands."""
        with self._lock:
            candidates = [r for r in self.replicas
                          if r.available() and r.has_capacity() and r.prefill_capable()]
            if not candidates:
                return None
            key = self._sticky_key(prompt)
            hit = self._sticky.get(key)
            tel = self.telemetry
            if hit is not None:
                rep = self.replicas[hit]
                if rep.available() and rep.has_capacity() and rep.prefill_capable():
                    self._sticky.move_to_end(key)
                    if tel.enabled:
                        tel.counter("serving/dispatch/sticky")
                    return rep
                if not rep.available() or not rep.prefill_capable():
                    del self._sticky[key]  # its owner left placement: re-home
            known = [r.ema_service_s for r in candidates if r.ema_service_s is not None]
            fallback = (sum(known) / len(known)) if known else 1.0
            n = len(self.replicas)
            rep = min(candidates, key=lambda r: (r.expected_drain_s(fallback), (r.idx - self._rr) % n))
            self._rr = (rep.idx + 1) % n
            self._sticky[key] = rep.idx
            self._sticky.move_to_end(key)
            while len(self._sticky) > self._sticky_capacity:
                self._sticky.popitem(last=False)
            if tel.enabled:
                tel.counter("serving/dispatch/least_loaded")
            return rep

    def dispatch(self, prompt, **submit_kwargs):
        """Route and submit: ``(replica, handle)``, or ``(None, None)`` when
        the fleet has no free slot (direct callers; the gateway routes and
        submits itself)."""
        rep = self.route(prompt)
        if rep is None:
            return None, None
        handle = rep.submit(prompt, **submit_kwargs)
        self.note_dispatch(rep)
        return rep, handle

    def note_dispatch(self, rep):
        """Account one placement on ``rep`` (after a successful submit)."""
        rep.dispatched += 1
        if self.telemetry.enabled:
            self.telemetry.counter(f"serving/replica/{rep.idx}/dispatched")

    # ---------------------------------------------------------------- drive
    def pump_once(self):
        """One single-threaded fleet turn: every replica claims parked
        handoffs, then the busy ones step. Returns whether anything
        progressed (the gateway's pumps make the same two calls, one
        replica each)."""
        progressed = False
        for rep in self.replicas:
            if self.admit_migrations(rep):
                progressed = True
            if not rep.idle() and not rep.sick:
                rep.step()
                progressed = True
        return progressed

    def drain_all_work(self):
        """Step every replica (and place parked handoffs) until the fleet is
        idle (direct callers)."""
        while True:
            if self.pump_once():
                continue
            if not self._migrations:
                return
            # handoffs parked but nothing progressed: their fetch is in
            # flight (join it), or no replica can ever take them (fail)
            if any(not rec.ready for rec in list(self._migrations)):
                for rep in self.replicas:
                    if rep.scheduler.kv_tier is not None:
                        rep.scheduler.kv_tier.executor.drain_fetches()
                continue
            if not any(r.available() for r in self.replicas):
                self._fail_handoffs()
                continue
            # ready records and an available replica that took none: no
            # decode-capable replica has room and nothing steps to free it
            raise RuntimeError(f"{len(self._migrations)} parked handoffs and no replica can adopt them")
