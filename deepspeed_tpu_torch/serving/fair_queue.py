"""Per-tenant weighted fair queue: deficit round-robin with priority classes.

The admission layer between the HTTP frontend and the scheduler. Every
queued request belongs to a *flow* — the ``(tenant, priority)`` pair — and
flows are served deficit-round-robin (Shreedhar & Varghese, SIGCOMM '95):
each visit in the rotation credits the flow ``quantum x weight`` deficit,
and the flow's head request pops once its deficit covers the request's
*cost* (estimated work: prompt tokens + max_tokens). Service converges to
weight-proportional token bandwidth per flow, so a tenant flooding the
queue cannot starve a light tenant: the light flow is visited every round
and its small backlog clears at its weighted share, keeping its time-to-
admission bounded by rounds, not by the heavy tenant's backlog depth.

Weights compose multiplicatively: ``tenant_weights[tenant] (default 1.0)
x priority_weights[priority]``, so "interactive" traffic from an ordinary
tenant can outrank "batch" traffic from a heavy one without a separate
strict-priority tier (which would reintroduce starvation).

Thread-safe: the HTTP side pushes from the event loop, the engine pump
thread pops; a single lock guards the rotation. Depth is bounded —
``push`` raises :class:`QueueFull` past ``max_depth``, which the gateway
maps to 429 + Retry-After (shed at the door, never an unbounded queue).

A copy of ``deepspeed_tpu/serving/fair_queue.py`` (stdlib only): the port imports nothing
of the JAX package.
"""

import collections
import threading
import time


class QueueFull(Exception):
    """The bounded fair queue is at ``max_depth``; shed the request."""


class _Flow:
    __slots__ = ("key", "tp", "weight", "deficit", "queue")

    def __init__(self, key, tp, weight):
        self.key = key
        self.tp = tp  # (tenant, priority) — the WEIGHT-bearing identity
        self.weight = weight
        self.deficit = 0.0
        self.queue = collections.deque()  # (cost, item, enq_monotonic_ts)


class FairQueue:
    """Bounded deficit-round-robin queue over ``(tenant, priority)`` flows.

    ``quantum``: deficit credited per rotation visit (cost units).
    ``tenant_weights``: tenant -> weight (default 1.0).
    ``priority_weights``: priority class -> weight multiplier; unknown
    classes fall back to the lowest configured weight (a client cannot
    invent a fast lane by sending a novel header value).
    """

    def __init__(self, max_depth=64, quantum=256, tenant_weights=None,
                 priority_weights=None):
        self.max_depth = int(max_depth)
        self.quantum = max(1.0, float(quantum))
        self.tenant_weights = dict(tenant_weights or {})
        self.priority_weights = dict(priority_weights or {}) or {"standard": 1.0}
        self._floor = min(self.priority_weights.values())
        self._lock = threading.Lock()
        self._flows = {}                        # key -> _Flow
        self._siblings = {}                     # (tenant, priority) -> live flow count
        self._rotation = collections.deque()    # _Flow service order
        self._fresh_turn = True                 # rotation head not yet credited
        self._depth = 0

    def _weight(self, tenant, priority):
        return (float(self.tenant_weights.get(tenant, 1.0))
                * float(self.priority_weights.get(priority, self._floor)))

    def push(self, item, tenant, priority, cost=1, adapter=None):
        """Enqueue ``item``; raises :class:`QueueFull` at the depth bound.

        ``adapter``: optional model-variant key (multi-LoRA serving) — it
        extends the FLOW key, so a tenant's traffic against different
        adapters forms separate DRR flows: one adapter's backlog cannot
        starve the same tenant's other variants. The WEIGHT still belongs
        to the ``(tenant, priority)`` pair: each turn's credit is divided
        by that pair's live flow count, so spreading a backlog across N
        adapters round-robins among them WITHOUT multiplying the tenant's
        bandwidth (a tenant cannot mint share by spraying adapter ids)."""
        cost = max(1, int(cost))
        with self._lock:
            if self._depth >= self.max_depth:
                raise QueueFull(f"fair queue at max_depth={self.max_depth}")
            tp = (str(tenant), str(priority))
            key = tp + ((str(adapter), ) if adapter is not None else ())
            flow = self._flows.get(key)
            if flow is None:
                flow = self._flows[key] = _Flow(key, tp,
                                                self._weight(tenant, priority))
                self._siblings[tp] = self._siblings.get(tp, 0) + 1
                self._rotation.append(flow)
            flow.queue.append((cost, item, time.monotonic()))
            self._depth += 1

    def pop(self):
        """Next request by DRR order, or None when empty.

        Turn semantics (the part naive implementations get wrong): the flow
        at the head of the rotation is credited ``quantum x weight`` ONCE
        per turn, serves heads while its deficit lasts, then rotates to the
        back — still holding any residual deficit. Crediting on every visit
        instead would let a backlogged flow re-earn its quantum after each
        pop and never yield the head: exactly the starvation DRR exists to
        prevent. Every turn either serves or rotates past a credited flow,
        and deficits grow monotonically until one covers its head's cost —
        the loop always terminates."""
        with self._lock:
            if self._depth == 0:
                return None
            while True:
                flow = self._rotation[0]
                if not flow.queue:
                    # emptied flows leave the rotation and forfeit deficit
                    # (standard DRR: idle flows must not bank credit)
                    self._rotation.popleft()
                    self._drop_flow(flow)
                    self._fresh_turn = True
                    continue
                if self._fresh_turn:
                    # the WEIGHT is per (tenant, priority): with k sibling
                    # flows (adapter variants) each turn earns 1/k of the
                    # pair's quantum, so the pair's total service stays
                    # weight-proportional no matter how many adapters its
                    # backlog spans (still >0: the loop terminates)
                    k = max(1, self._siblings.get(flow.tp, 1))
                    flow.deficit += self.quantum * flow.weight / k
                    self._fresh_turn = False
                cost = flow.queue[0][0]
                if flow.deficit < cost:
                    # turn over: next flow's turn begins, residual kept
                    self._rotation.rotate(-1)
                    self._fresh_turn = True
                    continue
                cost, item, _enq = flow.queue.popleft()
                flow.deficit -= cost
                self._depth -= 1
                if not flow.queue:
                    self._rotation.popleft()
                    self._drop_flow(flow)
                    self._fresh_turn = True
                return item

    def requeue(self, item, tenant, priority, cost=1, adapter=None):
        """Put a just-popped request BACK at the head of its flow, undoing
        the pop's accounting (depth and deficit restored, no fresh
        timestamp-based reordering: the tuple goes to the flow's FRONT).

        The gateway uses this when placement transiently fails AFTER a pop
        (a replica drained/sicked/changed phase role between the capacity
        check and the route): shedding an already-accepted request with a
        503 over a momentary eligibility blip would punish the client for
        fleet-internal churn. Depth may transiently exceed ``max_depth`` by
        the requeued item — it was already admitted once."""
        cost = max(1, int(cost))
        with self._lock:
            tp = (str(tenant), str(priority))
            key = tp + ((str(adapter), ) if adapter is not None else ())
            flow = self._flows.get(key)
            if flow is None:
                flow = self._flows[key] = _Flow(key, tp,
                                                self._weight(tenant, priority))
                self._siblings[tp] = self._siblings.get(tp, 0) + 1
                self._rotation.appendleft(flow)
            flow.queue.appendleft((cost, item, time.monotonic()))
            flow.deficit += cost
            self._depth += 1

    def _drop_flow(self, flow):
        del self._flows[flow.key]
        n = self._siblings.get(flow.tp, 1) - 1
        if n <= 0:
            self._siblings.pop(flow.tp, None)
        else:
            self._siblings[flow.tp] = n

    def __len__(self):
        return self._depth

    def depths(self):
        """{(tenant, priority): queued count} — introspection/metrics."""
        with self._lock:
            return {flow.key: len(flow.queue) for flow in self._flows.values()}

    def flow_stats(self):
        """Per-flow queue state for the fleet controller / metrics surface:
        ``{flow key: {tenant, priority, depth, oldest_wait_s, weight}}``.
        ``oldest_wait_s`` is the age of the flow's HEAD request — the
        per-flow head-of-line-wait the brownout ladder prices eviction by."""
        now = time.monotonic()
        with self._lock:
            return {
                flow.key: {
                    "tenant": flow.tp[0],
                    "priority": flow.tp[1],
                    "depth": len(flow.queue),
                    "oldest_wait_s": (round(now - flow.queue[0][2], 6)
                                      if flow.queue else 0.0),
                    "weight": flow.weight,
                }
                for flow in self._flows.values()}

    def tier_weight(self, priority):
        """The configured weight multiplier of a priority class (unknown
        classes resolve to the floor, same rule as admission)."""
        return float(self.priority_weights.get(str(priority), self._floor))

    def evict_flows(self, below_tier):
        """Brownout load shedding: remove every queued request whose flow's
        PRIORITY class weighs strictly less than ``below_tier``'s weight —
        tenant weights don't shield a low class (the ladder sheds by tier,
        not by tenant generosity). Returns the evicted ``(item, tenant,
        priority)`` rows, oldest-first within each flow; the caller owes
        each a 503 with a brownout ``Retry-After``. An unknown tier name
        resolves to the floor weight, so (strict comparison) it evicts
        nothing rather than everything."""
        bar = self.tier_weight(below_tier)
        evicted = []
        with self._lock:
            for flow in list(self._flows.values()):
                if self.tier_weight(flow.tp[1]) >= bar:
                    continue
                while flow.queue:
                    _cost, item, _enq = flow.queue.popleft()
                    evicted.append((item, flow.tp[0], flow.tp[1]))
                    self._depth -= 1
                # evicted flows leave the rotation like emptied ones (and
                # forfeit deficit); removing the rotation HEAD hands the
                # turn to the next flow with a fresh credit
                if self._rotation and self._rotation[0] is flow:
                    self._fresh_turn = True
                try:
                    self._rotation.remove(flow)
                except ValueError:
                    pass
                self._drop_flow(flow)
        return evicted

    def oldest_wait_s(self):
        """Age (seconds) of the longest-queued request across every flow —
        the head-of-line-wait signal the SLO/metrics surface reads; 0.0
        when empty."""
        now = time.monotonic()
        with self._lock:
            oldest = min((flow.queue[0][2] for flow in self._flows.values()
                          if flow.queue), default=None)
        return round(now - oldest, 6) if oldest is not None else 0.0
