"""Shared capacity/backoff math for the gateway and the multi-host router.

The gateway's ``Retry-After`` estimate and the router's fleet-wide backoff
must agree — both answer "how long until the current backlog drains through
the available slot pools at the measured per-request service time". Before
this module the math lived inline in ``Gateway._retry_after`` and silently
assumed every slot it divided by was local AND available, while the backlog
sums it divided iterated ALL replicas (including drained / pending-drain
ones) — a fleet mid-scale-down double-counted retiring backlogs against a
capacity surface that had already stopped advertising them.

Everything here works on a plain **capacity-signals dict** so the router can
merge per-worker signals it received over the wire without holding any
scheduler objects:

    {"queued":            fresh requests not yet placed (gateway fair queue),
     "inflight":          admitted requests not yet finished,
     "sched_backlog":     per-scheduler queue depths, AVAILABLE replicas only,
     "prefill_backlog":   same, prefill-capable AND available replicas only,
     "total_slots":       slots across available replicas,
     "prefill_slots":     slots across available prefill-capable replicas,
     "decode_slots":      slots across available decode-capable replicas,
     "ema_service_s":     per-request service-time EMA or None,
     "disaggregated":     phase-split fleet (True routes the phase-aware
                          estimate: a request needs a prefill slot first and
                          a decode slot after, and the pools are disjoint)}

``Gateway.capacity_signals()`` builds this dict locally; workers ship it in
heartbeats; the router merges the fleet's dicts with :func:`merge_signals`
and runs the SAME :func:`estimate_retry_after` the single-process gateway
runs. One formula, every surface.

A copy of ``deepspeed_tpu/serving/capacity_math.py`` (stdlib only): the port imports nothing
of the JAX package.
"""


def estimate_retry_after(sig, cap_s):
    """Integer Retry-After seconds (RFC 9110) from a capacity-signals dict.

    Identical math to the pre-refactor ``Gateway._retry_after``: with no
    service EMA yet, a conservative ``1 + depth // slots``; with an EMA,
    ``(depth + 1) * ema / slots``. Phase-aware when ``disaggregated`` — the
    estimate is the WORSE of (queued work / prefill capacity) and
    (in-flight work / decode capacity), not the blended depth over the
    blended fleet (which under-advertises exactly when one phase is the
    bottleneck). Floor 1s, capped, rounded up.
    """
    ema = sig.get("ema_service_s")

    def est(depth, slots):
        if ema is None:
            return 1 + depth // max(1, slots)
        return (depth + 1) * ema / max(1, slots)

    if sig.get("disaggregated"):
        pre_depth = int(sig.get("queued", 0)) + int(sig.get("prefill_backlog", 0))
        # inflight already covers parked handoffs (their handles are not
        # done) and soon-to-decode prefills — adding a migration count on
        # top would double-count each parked request
        dec_depth = int(sig.get("inflight", 0))
        val = max(est(pre_depth, int(sig.get("prefill_slots", 0))),
                  est(dec_depth, int(sig.get("decode_slots", 0))))
    else:
        depth = (int(sig.get("queued", 0)) + int(sig.get("inflight", 0))
                 + int(sig.get("sched_backlog", 0)))
        val = est(depth, int(sig.get("total_slots", 1)))
    return max(1, min(int(cap_s), int(val + 0.999)))


def merge_signals(signals):
    """Fold per-worker capacity-signals dicts into one fleet-wide dict.

    ``signals`` is an iterable of dicts as produced by
    ``Gateway.capacity_signals()`` — the caller filters to LIVE,
    non-draining workers first (a drained or dead worker contributes
    neither backlog nor slots; including either side alone would skew the
    estimate). Depths and slots sum; the EMA averages over workers that
    have one (None when none do); the fleet is disaggregated when any
    worker is phase-split — or when the workers themselves form the split
    (some prefill-only, some decode-only processes).
    """
    out = {"queued": 0, "inflight": 0, "sched_backlog": 0,
           "prefill_backlog": 0, "total_slots": 0, "prefill_slots": 0,
           "decode_slots": 0, "ema_service_s": None, "disaggregated": False}
    emas = []
    for sig in signals:
        if not sig:
            continue
        for key in ("queued", "inflight", "sched_backlog", "prefill_backlog",
                    "total_slots", "prefill_slots", "decode_slots"):
            out[key] += int(sig.get(key, 0))
        if sig.get("disaggregated"):
            out["disaggregated"] = True
        ema = sig.get("ema_service_s")
        if ema is not None:
            emas.append(float(ema))
    if emas:
        out["ema_service_s"] = sum(emas) / len(emas)
    # process-level phase split: a fleet of one prefill-role worker and one
    # decode-role worker is disaggregated even though each worker's local
    # fleet reports mixed math over its own (single-phase) pool
    if (not out["disaggregated"] and out["total_slots"]
            and (out["prefill_slots"] < out["total_slots"]
                 or out["decode_slots"] < out["total_slots"])):
        out["disaggregated"] = True
    return out
