"""Serving gateway: streaming HTTP frontend over the scheduler.

Port of ``deepspeed_tpu/serving/gateway.py``, stdlib only (``asyncio`` +
hand-rolled HTTP/1.1), over a fleet of replicas
(:class:`~deepspeed_tpu_torch.serving.replica.ReplicaSet`) on one card or
across the ranks of a mesh:

- **HTTP surface** (OpenAI-compatible where it can be, given the engine
  speaks token ids, not text): ``POST /v1/completions`` with ``"stream":
  true`` SSE token streaming (``data: {chunk}\\n\\n`` ... ``data: [DONE]``),
  ``GET /healthz`` (process liveness), ``GET /readyz`` (serving readiness —
  503 during drain), ``GET /v1/metrics`` (JSON gateway stats + the
  telemetry sink's :meth:`snapshot`; Prometheus text exposition under
  ``Accept: text/plain``/``openmetrics`` or ``?format=prometheus``),
  ``GET /v1/slo`` (the SLO engine's objective/burn-rate state), ``GET
  /v1/debug/flight`` (force a flight-recorder dump), ``POST
  /v1/debug/profile`` (a bounded ``torch.profiler`` capture; 409 while one
  runs), ``GET /v1/replicas`` and ``POST /v1/replicas/<i>/{drain,resume,
  role}`` (``role``: body ``{"role": "prefill"|"decode"|"mixed"}``, the
  phase role of disaggregated prefill/decode; 400 when the fleet would lose
  a phase).
  Prompts are token-id lists (or whitespace-separated decimal ids in a
  string); completions carry both ``token_ids`` and a space-joined decimal
  ``text``.

- **Request tracing**: an inbound W3C ``traceparent`` or ``x-request-id``
  names the request (minted otherwise); responses echo it as
  ``x-request-id`` and echo an inbound ``traceparent``. With telemetry and
  request tracing on, every request records a span tree (queued ->
  admitted -> prefix probe -> prefill chunks -> decode -> complete/cancel)
  on its own Perfetto track, flow-linked to the scheduler's ``sched/step``
  spans (``telemetry/tracing.py``).

- **SLOs + flight recorder**: the ``telemetry.slo`` section (or the default
  serving slate) is evaluated from the pump loop with multi-window burn
  rates; a burn-rate trip or a backend step failure dumps the flight
  recorder's ring. The JAX gateway's third trigger, an unexpected XLA
  recompile after warm-up, has no counterpart here: the port runs
  eagerly and compiles no programs.

- **Admission control**: a bounded per-tenant fair queue
  (:class:`~deepspeed_tpu_torch.serving.fair_queue.FairQueue`, deficit
  round-robin over ``(tenant, priority)``). Past ``max_queue_depth``
  requests shed with **429** and a ``Retry-After`` derived from live state
  (``serving/capacity_math.py``); during drain they shed with **503**.
  Every request carries a deadline (``request_timeout_s``, body
  ``timeout_s`` override downward): expiry — and client disconnect, seen
  as EOF on the connection — propagates ``handle.cancel()`` into the
  scheduler, so the KV slot frees mid-decode.

- **Graceful lifecycle**: ``begin_drain()`` (SIGTERM under ``python -m
  deepspeed_tpu_torch.serving``) flips readiness, stops admitting, finishes
  every admitted request, flushes telemetry and closes the server;
  ``drain_timeout_s`` bounds the grace.

``POST /v1/debug/flush_radix`` evicts every replica's radix trie through
the hierarchical KV tier on its pump thread (each eviction demotes to the
host store) and answers once the demotes are probe-visible.

- **Multi-host worker hooks** (``serving/router.py``'s
  :class:`~deepspeed_tpu_torch.serving.router.WorkerAgent` attaches them):
  ``POST /v1/store/fetch`` serves this process's networked store shard
  (``net_store``) to a remote restore; a prefill worker's handoff ends its
  response with a terminal ``handoff`` descriptor (an SSE event, or a
  ``handoff`` field of the unary reply) that only the router reads; and a
  completion body's ``resume`` (the router's, on a decode worker) rebuilds
  the handed-off request past the fair queue, since the prefill worker
  already admitted it.

Not ported, each answering 404 or 400 naming its ROADMAP item: the elastic
autoscaler (``/v1/autoscaler``, Queue 1 #9.5) and multi-LoRA adapters (a
completion body's ``adapter_id``, Queue 1 #9.3).

Threading: the asyncio event loop owns sockets and parsing; one pump thread
per replica makes every call into that replica's scheduler (a placement
made on another pump waits for it, ``Replica.turn``), and the pumps of one
process take turns at whole steps (``ReplicaSet``). Admission (a
fair-queue pop and its placement) and terminal accounting serialize on the
dispatch and finish locks; replica 0's pump also owns the fleet-wide duties (SLO evaluation,
flight dumps, the profiler's deadline). A replica whose step raises goes
sick and sheds its own requests while another serves; the last healthy one
fails what is in flight and keeps serving. Every pump wakes when a
migration's handoff is ready. Tokens cross from a pump to a response's
``asyncio.Queue`` through ``loop.call_soon_threadsafe`` from the
scheduler's ``on_token`` hook, so SSE events flush as each host sync lands.
All replicas launch on the device's default stream (a new thread's current
stream), one kernel after another.

**Across ranks** (a mesh of more than one rank: tensor, expert or seq
parallel, every rank holding its shard of the same engine): rank 0 runs
the gateway and every other rank runs :func:`follow`. Before each step of
a replica, rank 0's pump sends the scheduler calls made since that
replica's last step (submits with their rid and sampling arguments;
cancels, including deadlines and client disconnects, which only rank 0
sees; radix flushes) on the replica's own process groups, and every rank
applies them in order and steps (``ReplicaSet``'s lockstep). Each rank
checks the exchange: every rank's step count and the tokens its last step
delivered must agree (else every rank raises), and a follower's requests
after the calls must be rank 0's (else it raises before stepping). A rank
that raises stops; rank 0, raising or seeing its collectives fail when a
follower ends, fails its requests and exits non-zero. A step failure
across ranks ends the serving the same way (the ranks' collectives cannot
continue). At the drain rank 0 sends stop and every rank returns.

Telemetry: histograms ``gateway/queue_wait_ms``, ``gateway/ttfb_ms``;
gauges ``gateway/queue_depth``, ``gateway/active_requests``; counters
``gateway/requests``, ``gateway/completed``, ``gateway/tokens``,
``gateway/shed_429``, ``gateway/shed_503``, ``gateway/deadline_expired``,
``gateway/disconnects``, ``gateway/tenant/<tenant>/tokens``.
"""

import asyncio
import copy
import json
import os
import threading
import time

import numpy as np

from .. import comm as dist
from ..inference.config import GatewayConfig
from ..telemetry import (DEFAULT_SERVING_OBJECTIVES, RequestTrace, SLOEngine,
                         extract_trace_context)
from ..telemetry import prometheus as prom
from ..telemetry.profiler import ProfileBusy, TorchProfiler
from ..utils.logging import logger
from . import capacity_math
from .fair_queue import FairQueue, QueueFull
from .replica import ReplicaSet

_JSON = "application/json"
_AUTOSCALER = "ROADMAP Queue 1 #9.5, the elastic controller"
_LORA = "ROADMAP Queue 1 #9.3, multi-LoRA"


def _round_up(x, m):
    return (x + m - 1) // m * m


class _GatewayRequest:
    """One admitted-or-queued completion request: the handoff record between
    the HTTP handler (event loop) and the scheduler pump thread."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id", "do_sample",
                 "temperature", "top_k", "top_p", "seed", "tenant", "priority",
                 "cost", "deadline", "stream", "loop", "events", "handle",
                 "cancel_requested", "cancel_reason", "finished", "enq_ts",
                 "n_tokens", "trace", "trace_id", "replica",
                 "return_logits", "echo", "cancel_sent", "resume")

    def __init__(self, rid, prompt, *, max_new_tokens, eos_token_id, do_sample,
                 temperature, top_k, top_p, seed, tenant, priority, deadline,
                 stream, loop, trace=None, trace_id=None, return_logits=False, echo=(),
                 resume=None):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.tenant = tenant
        self.priority = priority
        self.cost = len(prompt) + max_new_tokens  # DRR work estimate
        self.deadline = deadline
        self.stream = stream
        self.loop = loop
        self.events = asyncio.Queue()
        self.handle = None
        self.cancel_requested = False
        self.cancel_reason = None
        self.finished = False
        self.enq_ts = time.monotonic()
        self.n_tokens = 0
        self.trace = trace          # RequestTrace (None when tracing is off)
        self.trace_id = trace_id    # request identity echoed as x-request-id
        self.replica = None         # the replica this request landed on
        self.return_logits = return_logits  # unary responses carry per-step logits
        self.echo = tuple(echo)     # identity headers every response carries
        self.cancel_sent = False    # the cancel went to its replica (sent once)
        # a cross-process resume: the handoff descriptor the router posted
        # (None for an ordinary arrival); it bypasses the fair queue
        self.resume = resume


class Gateway:
    """Serving gateway over one :class:`InferenceEngine`'s replica fleet
    (``continuous_batching.replicas``, replica 0 the engine's scheduler).

    ``Gateway(engine).start_background()`` binds the HTTP server (port 0 =
    ephemeral; the bound port lands on :attr:`port`) and starts the pump
    threads; ``begin_drain()`` initiates graceful shutdown and
    ``wait_drained()`` blocks until every admitted request finished and the
    server closed. ``run()`` is the blocking form the module entry point
    uses. ``config`` defaults to the engine config's ``gateway`` section;
    keyword overrides replace individual fields (on a copy: the engine's
    config is never mutated). Across ranks it runs on rank 0 (the other
    ranks :func:`follow`).
    """

    def __init__(self, engine, config=None, **overrides):
        if dist.is_initialized() and dist.get_rank() != 0:
            raise ValueError(f"the gateway serves on rank 0; rank {dist.get_rank()} runs "
                             f"deepspeed_tpu_torch.serving.gateway.follow(engine)")
        if config is None:
            config = getattr(engine._config, "gateway", None)
        if not isinstance(config, GatewayConfig):
            config = GatewayConfig(dict(config or {}))
        if overrides:
            # never mutate the caller's (usually the ENGINE's) config object
            # in place: a later Gateway(engine) would inherit the overrides
            config = copy.deepcopy(config)
        for key, val in overrides.items():
            if not hasattr(config, key):
                raise ValueError(f"unknown GatewayConfig override {key!r}")
            setattr(config, key, val)
        self.engine = engine
        self.config = config
        self.telemetry = engine.telemetry
        self.replicas = ReplicaSet.build(engine)
        self.scheduler = self.replicas.primary
        # each replica's pump makes every call into its scheduler; across
        # ranks they run in lockstep with the followers
        self.lockstep = dist.is_initialized() and dist.get_world_size() > 1
        for rep in self.replicas:
            rep.pumped = True
        self._fatal = None                   # across ranks: the error that ended serving
        self._broken = set()                 # replicas whose followers are gone
        self._fair = FairQueue(max_depth=config.max_queue_depth,
                               quantum=config.quantum_tokens,
                               tenant_weights=config.tenant_weights,
                               priority_weights=config.priority_weights)
        self.stats = {"requests": 0, "completed": 0, "tokens": 0, "shed_429": 0,
                      "shed_503": 0, "deadline_expired": 0, "disconnects": 0,
                      "rejected": 0, "handoffs_out": 0, "resumed_in": 0}
        self.host = config.host
        self.port = None  # bound port (after start)
        self.ready = False
        self.draining = False
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._tenant_labels = set()          # tenants with their own counter
        self._wake = threading.Event()       # pump wakeup
        self.replicas.on_migration_ready = self._wake.set  # a handoff is ready
        self._flush_radix_pending = set()    # replicas to flush (/v1/debug/flush_radix)
        # multi-host serving: the WorkerAgent attaches this process's
        # NetPrefixStore shard, which /v1/store/fetch serves (None otherwise)
        self.net_store = None
        self._active = set()                 # admitted, unfinished _GatewayRequests
        self._ema_service_s = None           # EMA of request wall time
        # admission (fair-queue pop + placement) and terminal accounting
        # (exactly once, when a cancel races the final token)
        self._dispatch_lock = threading.Lock()
        self._finish_lock = threading.Lock()
        self._loop = None
        self._server = None
        self._open_streams = 0               # responses still being written
        self._pump_threads = []
        self._loop_thread = None
        self._done_evt = threading.Event()   # fully drained + server closed
        self._force_stop = False
        # SLO engine over the shared sink: the telemetry config's 'slo'
        # section (or the default serving slate) evaluated from the pump
        # loop; burn-rate trips dump the flight recorder
        self.slo = None
        if self.telemetry.enabled:
            self.slo = SLOEngine(self.telemetry, getattr(self.telemetry, "slo_config", None),
                                 defaults=DEFAULT_SERVING_OBJECTIVES)
            if not self.slo.enabled:
                self.slo = None
            else:
                self.slo.on_alert.append(
                    lambda state: self.telemetry.dump_flight(f"slo_burn_{state['name']}", state))
        # operator flight-dump request (SIGUSR1): the handler only stores the
        # reason — dump_flight takes sink locks, and a handler interrupting a
        # flush on the same thread would deadlock on the io lock; the pump
        # performs the dump
        self._flight_request = None
        # on-demand torch.profiler captures (POST /v1/debug/profile), written
        # next to the flight dumps; a second request while one runs gets 409
        self.profiler = (TorchProfiler(self.telemetry.output_path)
                         if self.telemetry.enabled else None)

    # ------------------------------------------------------------------ lifecycle
    def start_background(self, timeout=120.0):
        """Start the server + pump on background threads; returns once the
        port is bound and the gateway is ready (raises on startup failure)."""
        ready = threading.Event()
        fail = []

        def runner():
            try:
                asyncio.run(self._serve(ready.set))
            except Exception as e:  # noqa: BLE001 — surface to the caller
                fail.append(e)
                ready.set()
            finally:
                self._done_evt.set()

        self._loop_thread = threading.Thread(target=runner, daemon=True, name="gateway-server")
        self._loop_thread.start()
        if not ready.wait(timeout):
            raise TimeoutError("gateway failed to bind within startup timeout")
        if fail:
            raise fail[0]
        return self

    def run(self):
        """Blocking serve-until-drained (the ``python -m`` entry point).
        Returns 0 after a clean drain. Signal handlers run on the main
        thread while this waits."""
        self.start_background()
        logger.info(f"gateway listening on {self.host}:{self.port}")
        print(json.dumps({"event": "GATEWAY_READY", "host": self.host, "port": self.port,
                          "pid": os.getpid()}), flush=True)
        while not self._done_evt.wait(0.2):
            pass
        if self.profiler is not None:
            self.profiler.stop()
        if self._fatal is not None:
            logger.error(f"gateway: serving ended on an error: {self._fatal}")
            return 1
        return 0

    def begin_drain(self):
        """Graceful shutdown trigger (SIGTERM handler / test hook; any
        thread): flip readiness, stop admitting, let the pump finish every
        admitted request, then close the server and flush telemetry."""
        if self.draining:
            return
        self.draining = True
        self.ready = False
        logger.info("gateway: drain initiated (no new admissions)")
        # the grace bound: past it, in-flight requests fail fast instead of
        # holding the process open
        timer = threading.Timer(float(self.config.drain_timeout_s), self._force)
        timer.daemon = True
        timer.start()
        self._wake.set()

    def _force(self):
        if not self._done_evt.is_set():
            logger.warning("gateway: drain timeout exceeded; forcing stop")
            self._force_stop = True
            self._wake.set()

    def request_flight_dump(self, reason):
        """Async-signal-safe flight-dump request (a plain attribute store):
        the pump thread performs the dump on its next turn."""
        self._flight_request = str(reason)
        self._wake.set()

    def wait_drained(self, timeout=None):
        """Block until drain completes (all admitted requests finished, the
        server closed). Returns False on timeout."""
        return self._done_evt.wait(timeout)

    def close(self, timeout=None):
        """begin_drain + wait_drained, for tests and benches."""
        self.begin_drain()
        done = self.wait_drained(timeout if timeout is not None
                                 else self.config.drain_timeout_s + 30)
        if self.profiler is not None:
            self.profiler.stop()  # a capture must not outlive the gateway
        return done

    async def _serve(self, ready_cb):
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        # one pump thread per replica, each owning its scheduler's steps
        for rep in self.replicas:
            t = threading.Thread(target=self._pump, args=(rep, ), daemon=True,
                                 name=f"gateway-pump-{rep.idx}")
            self._pump_threads.append(t)
            t.start()
        self.ready = True
        ready_cb()
        # pump exit == fully drained (each returns only when draining with
        # all admitted work finished, or on force-stop)
        while any(t.is_alive() for t in self._pump_threads):
            await asyncio.sleep(0.05)
        # let in-flight response writers flush their final events
        deadline = time.monotonic() + 10.0
        while self._open_streams > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        self._server.close()
        await self._server.wait_closed()
        try:
            self.telemetry.flush()
        except Exception:  # noqa: BLE001 — a sink failure must not fail drain
            logger.exception("gateway: telemetry flush failed at drain")
        logger.info("gateway: drained and closed")

    # ------------------------------------------------------------------ pump threads
    def _pump(self, rep):
        """One replica's pump: admit from the fair queue in DRR order (a
        fleet-wide decision, under the dispatch lock), claim parked
        handoffs, step THIS replica, enforce deadlines and cancellations.
        Replica 0's pump also runs the fleet-wide duties. Exits only when
        draining and every admitted request has finished (or on
        force-stop); across ranks it then sends the followers stop."""
        primary = rep.idx == 0
        while not self._force_stop:
            with self._dispatch_lock:
                self._enforce_cancellations()
                self._admit()
            try:
                # claim handoffs inside the step's guard: a restore failing
                # on the device degrades to sick-replica shedding
                self.replicas.admit_migrations(rep)
                flush = rep.idx in self._flush_radix_pending
                if flush:
                    rep.flush_radix()  # across ranks: in this turn, on every rank
                stepping = rep.turn()
                if flush:
                    self._flush_radix_pending.discard(rep.idx)
                if stepping and not rep.sick:
                    rep.step()
            except Exception as e:  # noqa: BLE001 — fail requests, not the server
                logger.exception(f"gateway: replica {rep.idx} scheduler step failed")
                self.telemetry.dump_flight("backend_error")
                if self.lockstep:
                    # the ranks cannot continue: fail everything, stop
                    self._broken.add(rep.idx)
                    self._fatal = f"replica {rep.idx}: {e}"
                    self._fail_in_flight(f"serving across ranks failed: {e}")
                    self._force_stop = True
                    break
                if len(self.replicas.healthy()) > 1:
                    # shed the sick replica, keep the fleet serving: its
                    # requests fail and its pump stops stepping it until
                    # resume()
                    self.replicas.mark_sick(rep.idx, "scheduler step failed")
                    self._fail_replica_in_flight(rep, "replica step failed")
                else:
                    # the last healthy replica: fail everything, stay up,
                    # retry on the next admitted request
                    self._fail_in_flight("scheduler step failed")
            self._settle_done()
            if primary:
                if self.slo is not None:
                    self.slo.maybe_evaluate()
                if self._flight_request is not None:
                    reason, self._flight_request = self._flight_request, None
                    self.telemetry.dump_flight(reason)
                if self.profiler is not None:
                    # belt-and-braces deadline: stops an overdue capture
                    self.profiler.poll()
            if rep.idle() or rep.sick:
                if self.draining and not len(self._fair) and not self._active:
                    break
                self._wake.wait(0.02)
                self._wake.clear()
        if self._force_stop and primary:
            # anything still in flight is failed, not silently dropped
            self._fail_in_flight("gateway shutdown")
        if self.lockstep and rep.idx not in self._broken:
            try:
                rep.turn(stop=True)
            except Exception as e:  # noqa: BLE001 — the followers diverged or are gone
                logger.exception(f"gateway: replica {rep.idx} could not stop its followers")
                self._fatal = self._fatal or f"replica {rep.idx}: {e}"

    def _admit(self):
        """Move requests from the DRR queue into scheduler slots while the
        replica has capacity (caller holds the dispatch lock). The
        scheduler's FIFO is kept empty (admission is 1:1 with free slots),
        so fair-queue order IS slot order."""
        tel = self.telemetry
        while True:
            if not self.replicas.any_capacity():
                if self.replicas.all_sick():
                    if len(self._fair):
                        self._fail_queue("no healthy serving replica")
                    if self.replicas.pending_migrations():
                        self.replicas._fail_handoffs()  # no adopter left either
                return
            greq = self._fair.pop()
            if greq is None:
                return
            if tel.enabled:
                tel.gauge("gateway/queue_depth", len(self._fair))
            if greq.cancel_requested:
                if greq.trace is not None:
                    greq.trace.instant("cancelled", where="queue")
                self._post(greq, ("cancelled", greq.cancel_reason or "cancelled"))
                continue
            now = time.monotonic()
            if greq.deadline is not None and now >= greq.deadline:
                self.stats["deadline_expired"] += 1
                if tel.enabled:
                    tel.counter("gateway/deadline_expired")
                if greq.trace is not None:
                    greq.trace.phase("queued", status="expired")
                    greq.trace.instant("expired", where="queue")
                self._post(greq, ("failed", 504, "deadline expired in queue"))
                continue
            rep = self.replicas.route(greq.prompt)
            if rep is None:
                # eligibility changed between the capacity check and the
                # pop (a drain, a sick replica, a role flip): requeue at the
                # flow head
                self._fair.requeue(greq, greq.tenant, greq.priority, cost=greq.cost)
                return
            try:
                handle = rep.submit(
                    greq.prompt, max_new_tokens=greq.max_new_tokens,
                    eos_token_id=greq.eos_token_id, do_sample=greq.do_sample,
                    temperature=greq.temperature, top_k=greq.top_k,
                    top_p=greq.top_p, seed=greq.seed,
                    collect_logits=True if greq.return_logits else None,
                    on_token=self._make_on_token(greq), trace=greq.trace)
            except ValueError as e:
                self.stats["rejected"] += 1
                if greq.trace is not None:
                    greq.trace.instant("rejected", error=str(e))
                self._post(greq, ("failed", 400, str(e)))
                continue
            greq.handle = handle
            greq.replica = rep
            self.replicas.note_dispatch(rep)
            self._wake.set()  # the replica's own pump queues it
            if greq.trace is not None:
                greq.trace.phase("queued", wait_ms=round((now - greq.enq_ts) * 1e3, 3))
                greq.trace.instant("admitted", replica=rep.idx)
            if tel.enabled:
                tel.histogram("gateway/queue_wait_ms", (now - greq.enq_ts) * 1e3)
            if handle.done:  # zero-budget edge: finished with no tokens
                self._finish(greq, ("done", "length"))
            else:
                self._active.add(greq)
                if tel.enabled:
                    tel.gauge("gateway/active_requests", len(self._active))

    def _make_on_token(self, greq):
        def on_token(tok, done):
            greq.n_tokens += 1
            reason = None
            if done:
                reason = ("stop" if (greq.eos_token_id is not None
                                     and tok == greq.eos_token_id) else "length")
                # account BEFORE posting the final token: a client that
                # reads the response then polls /v1/metrics must see its
                # own completion counted
                self._finish(greq, None)
            self._post(greq, ("token", int(tok), reason))
        return on_token

    def _finish(self, greq, event):
        """Request reached a terminal state on the pump side: account it,
        update the service-time EMA (feeds Retry-After), emit telemetry.
        Only requests that ran to completion count toward ``completed`` and
        the EMA (an abort-latency EMA would advertise too-small backoffs);
        token counters accrue either way. Exactly once, under the finish
        lock and the ``finished`` flag."""
        with self._finish_lock:
            if greq.finished:
                return
            greq.finished = True
            self._active.discard(greq)
            completed = event is None or event[0] == "done"
            if completed:
                service = time.monotonic() - greq.enq_ts
                ema = self._ema_service_s
                self._ema_service_s = service if ema is None else 0.9 * ema + 0.1 * service
                if greq.replica is not None:
                    greq.replica.observe_service(service)
                self.stats["completed"] += 1
            self.stats["tokens"] += greq.n_tokens
        if event is not None:
            self._post(greq, event)
        tel = self.telemetry
        if tel.enabled:
            if completed:
                tel.counter("gateway/completed")
            tel.counter("gateway/tokens", greq.n_tokens)
            # cardinality cap: the tenant id is client-controlled and sink
            # counters are never evicted
            tenant = greq.tenant
            if tenant not in self._tenant_labels:
                if len(self._tenant_labels) < 256:
                    self._tenant_labels.add(tenant)
                else:
                    tenant = "__other__"
            tel.counter(f"gateway/tenant/{tenant}/tokens", greq.n_tokens)
            tel.gauge("gateway/active_requests", len(self._active))

    def _enforce_cancellations(self):
        """Deadline expiry and HTTP-side cancellation (disconnect) propagate
        into the scheduler: ``handle.cancel()`` flags the slot, the next
        ``step()`` frees it (the scheduler never mutates mid-dispatch)."""
        now = time.monotonic()
        tel = self.telemetry
        for greq in list(self._active):
            if (not greq.cancel_requested and greq.deadline is not None
                    and now >= greq.deadline):
                greq.cancel_requested = True
                greq.cancel_reason = "deadline"
                self.stats["deadline_expired"] += 1
                if tel.enabled:
                    tel.counter("gateway/deadline_expired")
            if greq.cancel_requested and greq.handle is not None:
                self._cancel(greq)

    def _cancel(self, greq):
        """Propagate ``greq``'s cancel into its scheduler, once
        (:meth:`Replica.cancel` decides when it lands). A resume has no
        replica until one adopts it: the flag settles it while parked."""
        if not greq.cancel_sent:
            greq.cancel_sent = True
            if greq.replica is None:
                greq.handle.cancel()
            else:
                greq.replica.cancel(greq.handle)

    def _settle_done(self):
        """Cancelled and failed requests finish through the scheduler (done
        without a final on_token): confirm the terminal state to the HTTP
        side; a failed migration answers 500 with its reason."""
        for greq in list(self._active):
            if greq.handle is not None and greq.handle.done and not greq.finished:
                err = greq.handle._req.error
                if err is not None:
                    self._finish(greq, ("failed", 500, err))
                else:
                    self._finish(greq, ("cancelled", greq.cancel_reason or "cancelled"))

    def _fail_in_flight(self, msg):
        for greq in list(self._active):
            if greq.handle is not None:
                self._cancel(greq)
            self._finish(greq, ("failed", 500, msg))
        self._fail_queue(msg)

    def _fail_replica_in_flight(self, rep, msg):
        """Fail only the requests ``rep``'s scheduler holds now (a handoff
        migrated out is held by no scheduler, or by its decode replica).
        Runs on ``rep``'s pump, which first queues the submits waiting for
        it."""
        rep.turn()
        for greq in list(self._active):
            if greq.handle is not None and rep.scheduler.owns(greq.handle._req):
                self._cancel(greq)
                self._finish(greq, ("failed", 500, msg))

    def _fail_queue(self, msg):
        while True:
            greq = self._fair.pop()
            if greq is None:
                break
            self._post(greq, ("failed", 503, msg))

    def _post(self, greq, event):
        """Pump -> HTTP handler handoff; never raises (the response side may
        already be gone — its queue then just collects unread events)."""
        try:
            greq.loop.call_soon_threadsafe(greq.events.put_nowait, event)
        except RuntimeError:
            pass  # event loop closed mid-drain

    # ------------------------------------------------------------------ multi-host handoff
    def _handoff_complete(self, req, desc):
        """A cross-process prefill->decode handoff's demote landed (the
        WorkerAgent's migrate hook, on the KV transfer thread): finish the
        gateway request with a terminal ``("handoff", desc)`` event, so the
        response carries the descriptor instead of further tokens and the
        router resumes the request on a decode worker. Not a completion (no
        EMA fold, no completed count): the request lives on in another
        process. False when no in-flight gateway request owns ``req``."""
        for greq in list(self._active):
            if greq.handle is not None and greq.handle._req is req:
                self.stats["handoffs_out"] += 1
                self._finish(greq, ("handoff", desc))
                self._wake.set()
                return True
        return False

    def _admit_resume(self, greq):
        """Admit a router-posted resume (event-loop thread) past the fair
        queue, since the prefill worker already admitted the request
        fleet-wide: park it in the fleet's migration queue as a ready
        handoff whose entry is in the owner's shard, and the pumps'
        ``admit_migrations`` restores it bitwise."""
        # active first: a pump may adopt and finish it before this returns
        self._active.add(greq)
        try:
            greq.handle = self.replicas.inject_resume(greq.resume, on_token=self._make_on_token(greq),
                                                      trace=greq.trace, collect_logits=greq.return_logits)
        except (ValueError, KeyError, TypeError, NotImplementedError) as e:
            self._active.discard(greq)
            self.stats["rejected"] += 1
            self._post(greq, ("failed", 400, f"bad resume descriptor: {e}"))
            return
        self.stats["resumed_in"] += 1
        if self.telemetry.enabled:
            self.telemetry.gauge("gateway/active_requests", len(self._active))
        self._wake.set()

    def forward_widths(self):
        """The widths this process's slot-pool forwards ran at (the keys of
        every replica's ``forwards`` and ``ext_forwards`` counters), with
        their counts: the port's counterpart of a JAX worker's compiled
        program count, which the router's heartbeat carries."""
        out = {}
        for kind in ("forwards", "ext_forwards"):
            total = {}
            for rep in self.replicas:
                for width, n in getattr(rep.scheduler, kind).items():
                    total[str(width)] = total.get(str(width), 0) + int(n)
            out[kind] = dict(sorted(total.items(), key=lambda kv: int(kv[0])))
        return out

    # ------------------------------------------------------------------ admission math
    def capacity_signals(self):
        """Live capacity-signals dict (``serving/capacity_math.py`` shape):
        the one source both the local Retry-After and the multi-host
        router's fleet-wide merge read. Backlogs count available replicas
        only (a draining replica's slots are out of ``total_slots``, so its
        backlog must be too), and the phase split under disaggregation.
        ``inflight`` already holds parked handoffs (their handles are not
        done): adding the pending migrations would count them twice."""
        reps = self.replicas
        return {"queued": len(self._fair), "inflight": len(self._active),
                "sched_backlog": sum(len(r.scheduler.queue) for r in reps if r.available()),
                "prefill_backlog": sum(len(r.scheduler.queue) for r in reps
                                       if r.available() and r.prefill_capable()),
                "total_slots": reps.total_slots(),
                "prefill_slots": reps.phase_slots("prefill"),
                "decode_slots": reps.phase_slots("decode"),
                "ema_service_s": self._ema_service_s,
                "disaggregated": reps.disaggregated()}

    def _retry_after(self):
        """Advertised backoff from live state: the time for the backlog to
        drain through the slot pool at the measured per-request service
        time (EMA). Floor 1 s, capped, integer seconds per RFC 9110."""
        return capacity_math.estimate_retry_after(self.capacity_signals(),
                                                  self.config.retry_after_cap_s)

    def _next_rid(self):
        with self._rid_lock:
            self._rid += 1
            return self._rid

    # ------------------------------------------------------------------ HTTP layer
    async def _handle_conn(self, reader, writer):
        self._open_streams += 1
        try:
            req_line = await asyncio.wait_for(reader.readline(), 30.0)
            parts = req_line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0].upper(), parts[1]
            headers = {}
            # header-count bound (line LENGTH is bounded by the stream
            # reader's 64 KiB limit)
            for _ in range(128):
                line = await asyncio.wait_for(reader.readline(), 30.0)
                if line in (b"\r\n", b"\n", b""):
                    break
                key, _, val = line.decode("latin-1").partition(":")
                headers[key.strip().lower()] = val.strip()
            else:
                await self._json(writer, 431, {"error": {"message": "too many headers"}})
                return
            body = b""
            length = int(headers.get("content-length", "0") or 0)
            if length > int(self.config.max_body_bytes):
                # refuse BEFORE buffering: one fat POST must not OOM the
                # long-lived serving process
                await self._json(writer, 413,
                                 {"error": {"message": "request body exceeds "
                                            f"{self.config.max_body_bytes} bytes"}})
                return
            if length:
                body = await asyncio.wait_for(reader.readexactly(length), 30.0)
            await self._route(method, path, headers, body, reader, writer)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
            pass
        except Exception:  # noqa: BLE001 — one bad conn must not kill the server
            logger.exception("gateway: connection handler failed")
        finally:
            self._open_streams -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method, path, headers, body, reader, writer):
        path, _, query = path.partition("?")
        if method == "GET" and path == "/healthz":
            await self._json(writer, 200, {"status": "alive"})
        elif method == "GET" and path == "/readyz":
            if self.ready and not self.draining:
                await self._json(writer, 200, {"status": "ready"})
            else:
                await self._json(writer, 503,
                                 {"status": "draining" if self.draining else "starting"},
                                 extra=[("Retry-After", str(self._retry_after()))])
        elif method == "GET" and path == "/v1/metrics":
            # content negotiation: a Prometheus scraper's Accept leads with
            # text/plain (or openmetrics); everyone else gets JSON
            accept = headers.get("accept", "")
            want_prom = ("format=prometheus" in query
                         or (("text/plain" in accept or "openmetrics" in accept)
                             and _JSON not in accept))
            if want_prom:
                text = prom.render(self.telemetry.snapshot(),
                                   extra_gauges=self._prom_extra()).encode()
                writer.write(self._head(200, "text/plain; version=0.0.4; charset=utf-8",
                                        length=len(text)) + text)
                await writer.drain()
            else:
                await self._json(writer, 200, self._metrics())
        elif method == "GET" and path == "/v1/slo":
            state = (self.slo.state() if self.slo is not None
                     else {"enabled": False, "reason": "telemetry disabled or no objectives"})
            await self._json(writer, 200, state)
        elif method == "GET" and path == "/v1/debug/flight":
            dump = self.telemetry.dump_flight("debug_endpoint")
            if dump is None:
                await self._json(writer, 503,
                                 {"error": {"message": "flight recorder off, or rate-limited"}})
            else:
                await self._json(writer, 200,
                                 {"path": dump,
                                  "note": "file lands after the recorder's post-window elapses"})
        elif method == "POST" and path == "/v1/debug/profile":
            await self._profile(body, writer)
        elif method == "GET" and path == "/v1/replicas":
            await self._json(writer, 200, {"replicas": self.replicas.states()})
        elif method == "POST" and path.startswith("/v1/replicas/"):
            await self._replica_admin(path, body, writer)
        elif method == "POST" and path == "/v1/completions":
            await self._completions(headers, body, reader, writer)
        elif method == "POST" and path == "/v1/debug/flush_radix":
            # force-demote the radix tries through the KV tier; each pump
            # flushes its own scheduler and the endpoint waits for them
            self._flush_radix_pending = {r.idx for r in self.replicas if r.scheduler.radix is not None}
            self._wake.set()
            for _ in range(600):
                if not self._flush_radix_pending:
                    break
                await asyncio.sleep(0.05)
            await self._json(writer, 200, {"flushed": not self._flush_radix_pending})
        elif method == "POST" and path == "/v1/store/fetch":
            await self._store_fetch(body, writer)
        elif path == "/v1/autoscaler":
            await self._json(writer, 404, {"error": {"message": "deepspeed_tpu_torch does not serve the "
                                                     f"elastic autoscaler yet ({_AUTOSCALER})"}})
        else:
            await self._json(writer, 404, {"error": {"message": f"no route {method} {path}"}})

    async def _store_fetch(self, body, writer):
        """``POST /v1/store/fetch``: serve THIS shard's KV bytes to a remote
        restore in ``memory/net_store.py``'s wire format (one meta JSON
        line, then the leaves' raw bytes). The pop runs on an executor
        thread (it may read NVMe), so the loop keeps serving meanwhile."""
        if self.net_store is None:
            await self._json(writer, 404, {"error": {"message": "no networked store attached "
                                                     "(multi-host worker mode only)"}})
            return
        try:
            req = json.loads(body.decode("utf-8") or "{}")
            key = tuple(int(t) for t in req["key"])
            consume = bool(req.get("consume", True))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            await self._json(writer, 400, {"error": {"message": str(e)}})
            return
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(None, lambda: self.net_store.serve_fetch(key, consume=consume))
        if out is None:
            await self._json(writer, 404, {"error": {"message": "entry not resident (claimed, reaped "
                                                     "or evicted)"}})
            return
        payload, blob = out
        writer.write(self._head(200, "application/octet-stream", length=len(payload) + len(blob)))
        writer.write(payload)
        writer.write(blob)
        await writer.drain()

    async def _profile(self, body, writer):
        if self.profiler is None:
            await self._json(writer, 503, {"error": {"message": "telemetry disabled: "
                                                     "no profile output path"}})
            return
        try:
            req = json.loads(body) if body else {}
            duration_s = float(req.get("duration_ms", 1000.0) or 1000.0) / 1e3
        except (ValueError, TypeError, AttributeError):
            await self._json(writer, 400, {"error": {"message": "body must be a JSON object "
                                                     "with a numeric 'duration_ms'"}})
            return
        try:
            # the capture thread starts the profiler before start() returns
            loop = asyncio.get_running_loop()
            trace_dir = await loop.run_in_executor(None, self.profiler.start, duration_s,
                                                   "ondemand")
        except ProfileBusy as e:
            await self._json(writer, 409, {"error": {"message": str(e)}})
        else:
            await self._json(writer, 200, {"path": trace_dir, "duration_ms": duration_s * 1e3,
                                           "note": "the trace file lands when the capture "
                                                   "window elapses"})

    async def _replica_admin(self, path, body, writer):
        """``POST /v1/replicas/<idx>/drain`` stops placement onto a replica
        (in-flight work finishes; resumable); ``.../resume`` re-admits it
        (clearing drain and sick); ``.../role`` (body ``{"role":
        "prefill"|"decode"|"mixed"}``) flips its phase role (400 when the
        fleet would lose a phase)."""
        parts = path.strip("/").split("/")  # v1 replicas <idx> <action>
        if len(parts) != 4 or parts[3] not in ("drain", "resume", "role"):
            await self._json(writer, 404,
                             {"error": {"message": "POST /v1/replicas/<idx>/{drain|resume|role}"}})
            return
        try:
            idx = int(parts[2])
            if not 0 <= idx < len(self.replicas):
                raise ValueError
        except ValueError:
            await self._json(writer, 400, {"error": {"message": f"no replica {parts[2]!r} "
                                                     f"(fleet size {len(self.replicas)})"}})
            return
        if parts[3] == "role":
            try:
                req = json.loads(body.decode("utf-8") or "{}")
                state = self.replicas.set_role(idx, req.get("role") if isinstance(req, dict) else None)
            except (ValueError, UnicodeDecodeError, NotImplementedError) as e:
                await self._json(writer, 400, {"error": {"message": str(e)}})
                return
        else:
            state = self.replicas.drain(idx) if parts[3] == "drain" else self.replicas.resume(idx)
        self._wake.set()
        await self._json(writer, 200, {"replica": state})

    def _prom_extra(self):
        """Gateway/scheduler state the sink doesn't own, exposed as plain
        gauges on the Prometheus surface."""
        sched = self.scheduler
        out = {
            "gateway/ready": 1.0 if (self.ready and not self.draining) else 0.0,
            "gateway/queue_depth": float(len(self._fair)),
            "gateway/active_requests": float(len(self._active)),
            "gateway/oldest_queue_wait_s": self._fair.oldest_wait_s(),
            "gateway/retry_after_s": float(self._retry_after()),
            "scheduler/num_slots": float(sched.num_slots),
            "scheduler/active_slots": float(sched.cache.active_slots),
            "scheduler/slot_occupancy": float(sched.cache.occupancy()),
            "serving/replicas": float(len(self.replicas)),
            "serving/replicas_available": float(sum(1 for r in self.replicas if r.available())),
            "serving/tp_size": float(sched.tp_size),
            "serving/ep_size": float(sched.ep_size),
        }
        if self.replicas.disaggregated():
            # the phase split and the handoffs pending (per-replica roles are
            # in /v1/replicas; migrations_{out,in} are labeled counters)
            out.update({
                "serving/replicas_prefill_capable": float(
                    sum(1 for r in self.replicas if r.available() and r.prefill_capable())),
                "serving/replicas_decode_capable": float(
                    sum(1 for r in self.replicas if r.available() and r.decode_capable())),
                "serving/migrations_pending": float(self.replicas.pending_migrations()),
            })
        return out

    def _metrics(self):
        sched = self.scheduler
        return {
            "ready": self.ready,
            "draining": self.draining,
            "gateway": {**self.stats,
                        "queue_depth": len(self._fair),
                        "active_requests": len(self._active),
                        "queue_depth_per_flow": {"/".join(k): v
                                                 for k, v in self._fair.depths().items()},
                        "ema_service_s": self._ema_service_s,
                        "oldest_queue_wait_s": self._fair.oldest_wait_s(),
                        "retry_after_s": self._retry_after()},
            "slo": self.slo.state() if self.slo is not None else None,
            "scheduler": {"num_slots": sched.num_slots,
                          "active_slots": sched.cache.active_slots,
                          "queue_depth": len(sched.queue),
                          "slot_occupancy": sched.cache.occupancy(),
                          "tp_size": sched.tp_size,
                          "ep_size": sched.ep_size,
                          # the dispatch shapes so far ((chunk width, K),
                          # ("spec", W), ("prefill", bucket))
                          "dispatched": {str(k): v for k, v in sched.dispatched.items()},
                          # every replica's forward widths and their counts
                          "forward_widths": self.forward_widths(),
                          # fused decode layer: whether the step runs kernels
                          # A and C, and the gate's reasons when it does not
                          "fused_decode_block": sched._fused_block,
                          "fused_decode_reasons": list(sched._fused_block_reasons)},
            "replicas": self.replicas.states(),
            "disaggregation": ({
                "roles": [r.phase_role for r in self.replicas],
                "migrations": sum(r.scheduler.migrations_out for r in self.replicas),
                "pending": self.replicas.pending_migrations(),
                "failed": self.replicas.migrations_failed,
                "migrate_min_tokens": self.replicas.migrate_min_tokens,
            } if self.replicas.disaggregated() else None),
            # capacity rollup (telemetry/capacity.py): the dispatch-kind
            # roofline table, goodput and host-gap totals; the live gauges
            # are in the telemetry snapshot
            "capacity": ({
                "programs": sched.capacity.program_table(),
                "goodput_fraction": sched.capacity.goodput_fraction,
                "samples": sched.capacity.samples,
                "host_gaps": sched._gap.gaps,
                "host_gap_total_s": round(sched._gap.total_gap_s, 6),
                "profiling": self.profiler.active if self.profiler is not None else None,
            } if sched.capacity is not None else None),
            # multi-host serving: the networked shard's traffic
            # (net_bytes_{in,out}, remote_restores, leases_expired, ...)
            "net_store": self.net_store.stats() if self.net_store is not None else None,
            "device": self._device_memory(),
            "telemetry": self.telemetry.snapshot(),
        }

    def _device_memory(self):
        """This process's device memory on the card (bytes allocated now and
        at peak, the caching allocator's counts), or None on the host: a
        fleet of worker processes sharing one card reports each one's."""
        dev = self.engine.device
        if dev.type != "cuda":
            return None
        import torch
        return {"allocated_bytes": int(torch.cuda.memory_allocated(dev)),
                "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(dev))}

    # -------------------------------------------------------------- completions
    def _parse_completion(self, headers, body):
        """Request body -> kwargs. Raises ValueError with a client-facing
        message on malformed input."""
        try:
            req = json.loads(body.decode("utf-8") or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"body is not valid JSON: {e}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        resume = req.get("resume")
        if resume is not None:
            # a cross-process resume (router -> decode worker): the
            # descriptor is the request, its prompt and sampling arguments
            # travel in it, so the resumed decode is bitwise the one it
            # continues
            if not isinstance(resume, dict):
                raise ValueError("'resume' must be a handoff descriptor object")
            for field in ("key", "kv_len", "version", "owner_url", "prompt", "max_new_tokens"):
                if field not in resume:
                    raise ValueError(f"resume descriptor missing {field!r}")
            req = dict(req, prompt=resume["prompt"], max_tokens=int(resume["max_new_tokens"]),
                       eos_token_id=resume.get("eos_token_id"), do_sample=resume.get("do_sample", False),
                       temperature=resume.get("temperature", 0.0), top_k=resume.get("top_k", 0),
                       top_p=resume.get("top_p", 1.0), seed=resume.get("seed", 0),
                       adapter_id=resume.get("adapter_id"))
        if req.get("adapter_id") is not None:
            raise ValueError("multi-LoRA serving is not enabled (continuous_batching.multi_lora; "
                             f"{_LORA})")
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            try:
                prompt = [int(t) for t in prompt.split()]
            except ValueError:
                raise ValueError("string prompts must be whitespace-separated decimal token ids "
                                 "(the engine has no tokenizer)")
        if (not isinstance(prompt, (list, tuple)) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of token ids")
        cfg = self.config
        max_tokens = req.get("max_tokens", cfg.default_max_tokens)
        if not isinstance(max_tokens, int) or max_tokens < 0:
            raise ValueError("'max_tokens' must be a non-negative integer")
        temperature = float(req.get("temperature") or 0.0)
        do_sample = bool(req.get("do_sample", temperature > 0.0))
        timeout_s = req.get("timeout_s")
        if timeout_s is None:
            timeout_s = float(cfg.request_timeout_s)  # <= 0: operator opt-out
        else:
            if not isinstance(timeout_s, (int, float)) \
                    or isinstance(timeout_s, bool) or timeout_s <= 0:
                # a client 0/negative must NOT mean "no deadline": only the
                # operator (request_timeout_s <= 0) can disable the policy
                raise ValueError("'timeout_s' must be a positive number")
            timeout_s = float(timeout_s)
            if cfg.request_timeout_s > 0:  # body overrides downward only
                timeout_s = min(timeout_s, float(cfg.request_timeout_s))
        tenant = headers.get(cfg.tenant_header.lower()) or req.get("user") or "anonymous"
        priority = (headers.get(cfg.priority_header.lower()) or req.get("priority")
                    or cfg.default_priority)
        sched = self.scheduler
        # capacity pre-check mirrors DecodeScheduler.submit's validation so
        # impossible requests 400 immediately instead of queueing first
        budget = _round_up(max(1, max_tokens), sched.steps_per_sync)
        cap = sched.cache.spannable_len if sched.prefill_chunk > 0 else sched.max_len
        if len(prompt) >= cap or len(prompt) + budget > cap:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_tokens ({max_tokens}) exceeds "
                f"the per-slot KV capacity {sched.max_len} x "
                f"{sched.cache.max_extents} extent(s) = {cap} spannable rows")
        return dict(
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_tokens,
            eos_token_id=req.get("eos_token_id"),
            do_sample=do_sample,
            temperature=temperature if temperature > 0 else 1.0,
            top_k=int(req.get("top_k") or 0),
            top_p=float(req.get("top_p") or 1.0),
            seed=int(req.get("seed") or 0),
            tenant=str(tenant),
            priority=str(priority),
            deadline=(time.monotonic() + timeout_s) if timeout_s > 0 else None,
            stream=bool(req.get("stream", False)),
            return_logits=bool(req.get("return_logits", False)),
            resume=resume,
        )

    async def _completions(self, headers, body, reader, writer):
        tel = self.telemetry
        self.stats["requests"] += 1
        if tel.enabled:
            tel.counter("gateway/requests")
        if self.draining or not self.ready:
            self.stats["shed_503"] += 1
            if tel.enabled:
                tel.counter("gateway/shed_503")
            await self._json(writer, 503, {"error": {"message": "gateway is draining",
                                                     "type": "unavailable"}},
                             extra=[("Retry-After", str(self._retry_after()))])
            return
        try:
            kwargs = self._parse_completion(headers, body)
        except (ValueError, TypeError) as e:
            # TypeError covers non-numeric JSON (e.g. "top_k": [1]) reaching
            # int()/float(): a client error, answered 400
            self.stats["rejected"] += 1
            await self._json(writer, 400, {"error": {"message": str(e),
                                                     "type": "invalid_request"}})
            return
        # request identity: an inbound W3C traceparent / x-request-id, else
        # a minted id; echoed back as x-request-id (an inbound traceparent
        # is echoed too) and used as the span tree's track id
        trace_id, parent, _ = extract_trace_context(headers)
        echo = [("x-request-id", trace_id)]
        if parent is not None:
            echo.append(("traceparent", headers["traceparent"]))
        trace = None
        if tel.enabled and getattr(tel, "trace_requests", False):
            trace = RequestTrace(tel, trace_id, parent, tenant=kwargs["tenant"],
                                 priority=kwargs["priority"])
            trace.mark("queued")
        greq = _GatewayRequest(self._next_rid(), loop=asyncio.get_running_loop(), trace=trace,
                               trace_id=trace_id, echo=echo, **kwargs)
        if trace is not None:
            trace.rid = greq.rid
            # one track per request: a client may reuse an x-request-id
            # across concurrent retries (the bare id is what x-request-id
            # echoes)
            trace.track = f"{trace_id}:{greq.rid}"
        if greq.resume is not None:
            # fleet-wide admission happened on the prefill worker: queueing
            # it again would charge its tenant twice and could deadlock a
            # full queue
            self._admit_resume(greq)
        else:
            try:
                self._fair.push(greq, greq.tenant, greq.priority, cost=greq.cost)
            except QueueFull:
                self.stats["shed_429"] += 1
                if tel.enabled:
                    tel.counter("gateway/shed_429")
                await self._json(writer, 429,
                                 {"error": {"message": "server overloaded: request queue is full, "
                                            "retry later", "type": "overloaded"}},
                                 extra=[("Retry-After", str(self._retry_after()))] + echo)
                return
            if tel.enabled:
                tel.gauge("gateway/queue_depth", len(self._fair))
            self._wake.set()
        if greq.stream:
            await self._respond_stream(greq, reader, writer)
        else:
            await self._respond_unary(greq, reader, writer)

    async def _next_event(self, greq, eof_task):
        """One event from the pump, or ('disconnect',) when the client goes
        away first. The generous timeout is a safety net — the pump enforces
        the real deadline; with deadlines disabled by the operator there is
        no safety net either."""
        if self.config.request_timeout_s > 0:
            timeout = self.config.request_timeout_s + self.config.drain_timeout_s + 30
        else:
            timeout = None
        get_task = asyncio.ensure_future(greq.events.get())
        done, _ = await asyncio.wait({get_task, eof_task}, timeout=timeout,
                                     return_when=asyncio.FIRST_COMPLETED)
        if get_task in done:
            return get_task.result()
        get_task.cancel()
        if eof_task in done:
            return ("disconnect", )
        # safety-net trip: CANCEL the request, don't just abandon it
        greq.cancel_requested = True
        greq.cancel_reason = "gateway timeout"
        self._wake.set()
        return ("failed", 500, "gateway timed out waiting on the scheduler")

    def _client_gone(self, greq):
        self.stats["disconnects"] += 1
        if self.telemetry.enabled:
            self.telemetry.counter("gateway/disconnects")
        greq.cancel_requested = True
        greq.cancel_reason = "disconnect"
        self._wake.set()

    @staticmethod
    async def _watch_eof(reader):
        """Resolves when the client closes its half of the connection (EOF
        past the request body: nothing more to pipeline on a Connection:
        close exchange)."""
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    return
        except (ConnectionError, OSError):  # reset == gone
            return

    def _chunk(self, greq, toks, finish_reason):
        return {"id": f"cmpl-{greq.rid}", "object": "text_completion.chunk",
                "model": type(self.engine.module).__name__,
                "choices": [{"index": 0, "text": "".join(f"{t} " for t in toks),
                             "token_ids": toks, "finish_reason": finish_reason}]}

    async def _respond_stream(self, greq, reader, writer):
        eof_task = asyncio.ensure_future(self._watch_eof(reader))
        tel = self.telemetry
        headers_sent = False
        try:
            while True:
                ev = await self._next_event(greq, eof_task)
                kind = ev[0]
                if kind == "disconnect":
                    self._client_gone(greq)
                    return
                if kind == "failed":
                    if not headers_sent:
                        await self._json(writer, ev[1], {"error": {"message": ev[2]}},
                                         extra=greq.echo)
                    return
                if not headers_sent:
                    headers_sent = True
                    writer.write(self._head(200, "text/event-stream",
                                            [("Cache-Control", "no-cache")] + list(greq.echo)))
                    if tel.enabled:
                        tel.histogram("gateway/ttfb_ms", (time.monotonic() - greq.enq_ts) * 1e3)
                if kind == "token":
                    _, tok, reason = ev
                    payload = json.dumps(self._chunk(greq, [tok], reason))
                    writer.write(f"data: {payload}\n\n".encode())
                    await writer.drain()
                    if reason is not None:
                        break
                elif kind == "handoff":
                    # a cross-process migration: the stream ends here with
                    # the descriptor, which the router (the only client that
                    # sees this event) consumes to resume the request on a
                    # decode worker and stitch that stream on
                    writer.write(f"data: {json.dumps({'handoff': ev[1]})}\n\n".encode())
                    break
                else:  # "done" / "cancelled": a last empty chunk with the reason
                    payload = json.dumps(self._chunk(greq, [], ev[1]))
                    writer.write(f"data: {payload}\n\n".encode())
                    break
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except ConnectionError:
            self._client_gone(greq)
        finally:
            eof_task.cancel()

    async def _respond_unary(self, greq, reader, writer):
        eof_task = asyncio.ensure_future(self._watch_eof(reader))
        toks = []
        finish_reason = None
        handoff = None
        try:
            while True:
                ev = await self._next_event(greq, eof_task)
                kind = ev[0]
                if kind == "disconnect":
                    self._client_gone(greq)
                    return
                if kind == "failed":
                    await self._json(writer, ev[1], {"error": {"message": ev[2]}},
                                     extra=greq.echo)
                    return
                if kind == "token":
                    _, tok, reason = ev
                    toks.append(tok)
                    if reason is not None:
                        finish_reason = reason
                        break
                elif kind == "handoff":
                    # a cross-process migration: a partial reply, the tokens
                    # so far and the descriptor the router resumes from
                    finish_reason = "handoff"
                    handoff = ev[1]
                    break
                else:  # "done" / "cancelled"
                    finish_reason = ev[1]
                    break
            if finish_reason == "deadline" and not toks:
                await self._json(writer, 504, {"error": {"message": "deadline expired"}},
                                 extra=greq.echo)
                return
            if self.telemetry.enabled:
                self.telemetry.histogram("gateway/ttfb_ms",
                                         (time.monotonic() - greq.enq_ts) * 1e3)
            out = {
                "id": f"cmpl-{greq.rid}", "object": "text_completion",
                "model": type(self.engine.module).__name__,
                "choices": [{"index": 0, "text": " ".join(str(t) for t in toks),
                             "token_ids": toks, "finish_reason": finish_reason}],
                "usage": {"prompt_tokens": int(len(greq.prompt)),
                          "completion_tokens": len(toks),
                          "total_tokens": int(len(greq.prompt)) + len(toks)},
            }
            if handoff is not None:
                out["handoff"] = handoff
            if greq.return_logits and greq.handle is not None:
                # float32 -> JSON double is exact: the logits survive the
                # process boundary bitwise
                out["logits"] = [np.asarray(step, np.float32).tolist()
                                 for step in greq.handle._req.logits]
            await self._json(writer, 200, out, extra=greq.echo)
        except ConnectionError:
            self._client_gone(greq)
        finally:
            eof_task.cancel()

    # ------------------------------------------------------------------ HTTP writing
    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 409: "Conflict",
                413: "Content Too Large", 429: "Too Many Requests",
                431: "Request Header Fields Too Large", 503: "Service Unavailable",
                504: "Gateway Timeout", 500: "Internal Server Error"}

    def _head(self, status, ctype, extra=(), length=None):
        lines = [f"HTTP/1.1 {status} {self._REASONS.get(status, 'Unknown')}",
                 f"Content-Type: {ctype}", "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        for key, val in extra:
            lines.append(f"{key}: {val}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode()

    async def _json(self, writer, status, obj, extra=()):
        body = json.dumps(obj).encode()
        writer.write(self._head(status, _JSON, extra, length=len(body)) + body)
        await writer.drain()


def follow(engine):
    """A following rank's serving loop (every rank but 0 of a mesh whose
    rank 0 runs the :class:`Gateway`): build the same fleet, then one thread
    per replica takes rank 0's calls and steps in lockstep
    (:meth:`Replica.follow`) until rank 0 stops it. Returns 0; raises the
    first replica's error (a divergence from rank 0) at once."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        raise ValueError("follow() runs on the ranks other than 0 of a world that serves across ranks")
    replicas = ReplicaSet.build(engine)
    errors = []

    def run(rep):
        try:
            rep.follow()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            logger.exception(f"follower: replica {rep.idx} stopped")
            errors.append(e)

    threads = [threading.Thread(target=run, args=(rep, ), daemon=True, name=f"follow-{rep.idx}")
               for rep in replicas]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive() and not errors:
            t.join(0.2)
        if errors:
            # the other replicas' threads wait on rank 0, which learns of
            # this from its collectives failing once this process ends
            raise errors[0]
    return 0
