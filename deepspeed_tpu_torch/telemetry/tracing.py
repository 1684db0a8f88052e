"""Request-scoped distributed tracing.

Mints/propagates a per-request trace id at the serving gateway (W3C
``traceparent`` or ``x-request-id`` inbound headers; generated otherwise)
and records the request's phase tree — queued -> admitted -> prefix-cache
probe -> prefill chunks -> decode -> complete/cancel — as async spans on a
per-request Perfetto track in the shared :class:`TelemetrySink`. Phases
that were executed by a shared scheduler iteration carry *flow* ids binding
them to that iteration's ``sched/step`` span, so one request's latency can
be read off the same timeline as the batch it rode in.

Span naming: every phase is ``req/<phase>``; JSONL lines carry
``track`` (the trace id — suffixed ``:<rid>`` by the gateway so reused
client ids stay distinct tracks) plus ``attrs.rid``/``attrs.tenant``,
which is what ``tools/trace_summary.py --requests`` reconstructs the
per-request view from.

A copy of ``deepspeed_tpu/telemetry/tracing.py`` (stdlib only): the port imports nothing
of the JAX package.
"""

import re
import uuid

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def make_trace_id():
    """A fresh 32-hex trace id (W3C trace-context shaped)."""
    return uuid.uuid4().hex


def extract_trace_context(headers):
    """Inbound trace identity from an HTTP header dict (lower-cased keys):
    a W3C ``traceparent`` wins, then ``x-request-id``, else a fresh id.
    Returns ``(trace_id, parent_span_id_or_None, propagated)``."""
    tp = (headers or {}).get("traceparent", "")
    m = _TRACEPARENT_RE.match(tp.strip().lower()) if tp else None
    if m:
        trace_id, parent = m.group(1), m.group(2)
        if trace_id != "0" * 32:
            return trace_id, parent, True
    rid = (headers or {}).get("x-request-id")
    if rid:
        # sanitize to a safe track id; keep it recognizably the caller's
        rid = "".join(c for c in str(rid) if c.isalnum() or c in "-_")[:64]
        if rid:
            return rid, None, True
    return make_trace_id(), None, False


class RequestTrace:
    """Phase recorder for ONE request, shared between the gateway and the
    scheduler (threaded through ``DecodeScheduler.submit(trace=...)``).

    All methods no-op once the sink is disabled, so a trace object can
    always be passed without re-checking. ``link()`` mints a flow id that
    the scheduler adds to its iteration span's ``flow_out`` while the
    request phase records it as ``flow_in`` — the connective tissue between
    the per-request tree and the shared per-iteration spans."""

    __slots__ = ("sink", "trace_id", "parent", "rid", "track", "attrs",
                 "marks", "_flow_seq")

    def __init__(self, sink, trace_id=None, parent=None, track=None, **attrs):
        self.sink = sink
        self.trace_id = trace_id or make_trace_id()
        self.parent = parent
        self.rid = None  # scheduler request id, filled at submit
        # the Perfetto track id. Defaults to the trace id; the gateway
        # suffixes its request id (``<trace_id>:<rid>``) because a client
        # may REUSE an x-request-id across concurrent retries — two
        # requests sharing one async track would interleave their b/e
        # pairs into one garbled tree and mint colliding flow ids
        self.track = track or self.trace_id
        self.attrs = {k: v for k, v in attrs.items() if v is not None}
        self.marks = {}
        self._flow_seq = 0

    @property
    def enabled(self):
        return self.sink is not None and self.sink.enabled

    def mark(self, name, ts=None):
        """Remember a timestamp for a later phase() to use as its start."""
        if self.enabled:
            self.marks[name] = self.sink.now() if ts is None else ts

    def link(self):
        """A fresh flow id tying the NEXT recorded phase to the scheduler
        iteration span that carries the same id in ``flow_out``."""
        self._flow_seq += 1
        return f"{self.track}/{self._flow_seq}"

    def _attrs(self, extra):
        out = dict(self.attrs)
        if self.rid is not None:
            out["rid"] = self.rid
        if self.parent:
            out["parent"] = self.parent
        if self.track != self.trace_id:
            out["trace"] = self.trace_id  # correlation key across retries
        out.update({k: v for k, v in extra.items() if v is not None})
        return out

    def phase(self, name, start=None, end=None, flow_in=None, **attrs):
        """Record phase ``req/<name>`` on this request's track. ``start``
        defaults to the mark of the same name (consumed), ``end`` to now."""
        if not self.enabled:
            return
        now = self.sink.now()
        if start is None:
            start = self.marks.pop(name, now)
        if end is None:
            end = now
        self.sink.record_async(f"req/{name}", self.track, start,
                               max(0.0, end - start), attrs=self._attrs(attrs),
                               flow_in=flow_in)

    def instant(self, name, **attrs):
        """Record instant milestone ``req/<name>`` on this request's track."""
        if not self.enabled:
            return
        self.sink.event(f"req/{name}", attrs=self._attrs(attrs),
                        track=self.track)
