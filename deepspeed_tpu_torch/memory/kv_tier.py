"""Per-scheduler KV tier client: demotion and restoration between the slot
pool on the device and the host prefix store.

Port of ``deepspeed_tpu/memory/kv_tier.py``. One :class:`KVTier` hangs
off each :class:`~deepspeed_tpu_torch.inference.scheduler.DecodeScheduler`
whose config enables the hierarchical KV tier, and rides the streaming
layer (:class:`~deepspeed_tpu_torch.memory.streams.LayerStreamExecutor`):

- **demote** (radix eviction -> host): the rows a demote keeps (the
  prefix's ``m`` rows of every pool leaf, nothing past them) are first
  copied into ONE fresh flat device buffer on the compute stream. The
  eviction hands the slot straight to the admission whose prefill
  rewrites it, so reading the pool itself from the copy stream or the
  transfer thread would capture the new request's KV. One ``non_blocking``
  copy on the executor's fetch stream then moves the buffer into a pinned
  staging buffer (a ring of ``fetch_window + 1``, registered at their
  size), and the fetch, on the transfer pool inside the executor's bounded
  window, waits for it, copies the bytes into pageable host memory,
  returns the staging buffer and registers the entry in the store.
- **restore** (host store -> a slot, ahead of chunked prefill): the
  entry's first ``matched`` rows are packed into ONE persistent pinned
  staging buffer, put to the device in one copy on the executor's put
  stream (at depth 0 the put is fenced before ``take`` returns, so the
  staging may be rewritten by the next restore), and the compute stream
  waits on the put's event before it writes the rows into the slot.
  The restored rows are the bytes the demote fetched, so restored ==
  device hit == cold decode (the suffix chunk-prefills on the same chunk
  boundaries either way).

Every leaf of the pool rides through generically, sliced on its row axis
(``ndim - 2``): the plain bf16/fp32 pools and the int8 pool's three leaves
a layer (k, v, and (num_slots, 1, max_len, 1) fp16 scales) alike. Staging
is allocated on the first demote and restore (or :meth:`warmup`) and
reused after: ``staging_allocs`` counts the buffers allocated. On the CPU
the gathered rows already are host memory, so demotes skip the ring.
"""

import threading

import torch

from .streams import LayerStreamExecutor

_ALIGN = 64  # byte alignment of each leaf inside a flat transfer buffer


class KVTier:
    """Demote/restore client binding one scheduler to a shared
    :class:`~deepspeed_tpu_torch.memory.prefix_store.GlobalPrefixStore`.

    ``min_restore_tokens``: the restore-vs-recompute threshold; a host
    match shorter than this (after chunk rounding) chunk-prefills cold
    instead of paying the host-to-device copy."""

    def __init__(self, scheduler, store, min_restore_tokens=0, fetch_window=2):
        self.sched = scheduler
        self.kv = scheduler.cache
        self.store = store
        self.device = torch.device(scheduler.device)
        self.min_restore_tokens = max(0, int(min_restore_tokens))
        # depth 0: restore puts are fenced at the point of use (the
        # persistent staging is rewritten by the next restore); the async
        # half of the tier is the demote fetch window
        self.executor = LayerStreamExecutor(self._dispatch_restore, None, prefetch_depth=0,
                                            fetch_window=fetch_window, device=self.device)
        self._stages = None     # demote staging ring (the card only)
        self._stage_cv = threading.Condition()
        self._restore_stage = None
        self._pending = None    # the flat host bytes of the restore in flight
        self.staging_allocs = 0
        self.demotes = 0
        self.restores = 0
        self.restored_tokens = 0

    # ------------------------------------------------------------------ layout
    def _leaves(self):
        return [leaf for comp in self.kv.pool for leaf in comp]

    def _layout(self, rows):
        """``([(offset, nbytes, shape, dtype)] per pool leaf, total bytes)``
        of ``rows`` rows of one slot packed into a flat byte buffer: each
        leaf as its (1, ..., rows, last) block at a 64-byte aligned offset."""
        out, off = [], 0
        for leaf in self._leaves():
            shape = (1, ) + tuple(leaf.shape[1:-2]) + (int(rows), int(leaf.shape[-1]))
            n = 1
            for d in shape:
                n *= d
            nb = n * leaf.element_size()
            out.append((off, nb, shape, leaf.dtype))
            off += -(-nb // _ALIGN) * _ALIGN
        return out, off

    @staticmethod
    def _views(flat, lay):
        return [flat[off:off + nb].view(dtype).view(shape) for off, nb, shape, dtype in lay]

    def _host_buffer(self, nbytes):
        from ..runtime.zero.offload import host_buffer
        self.staging_allocs += 1
        return host_buffer(nbytes, torch.uint8, pin=self.device.type == "cuda").zero_()

    # ------------------------------------------------------------------ demote
    def _gather(self, slot, rows):
        """Rows ``[0, rows)`` of ``slot`` in every pool leaf, copied into one
        FRESH flat buffer on the compute stream (never a view of the pool:
        the slot may be rewritten the moment this returns)."""
        lay, total = self._layout(rows)
        flat = torch.empty(total, dtype=torch.uint8, device=self.device)
        for leaf, dst in zip(self._leaves(), self._views(flat, lay)):
            dst.copy_(leaf[slot:slot + 1][..., :rows, :])
        return flat, lay

    def _acquire_stage(self):
        with self._stage_cv:
            if self._stages is None:
                total = self._layout(self.kv.max_len)[1]
                self._stages = [self._host_buffer(total) for _ in range(self.executor.window + 1)]
            while not self._stages:
                self._stage_cv.wait()
            return self._stages.pop()

    def _release_stage(self, stage):
        with self._stage_cv:
            self._stages.append(stage)
            self._stage_cv.notify()

    def _copy_out(self, slot, rows):
        """Gather ``slot``'s first ``rows`` rows and start their copy to the
        host. Returns ``finish()`` giving the host leaves (views of one
        pageable buffer); on the card it waits for the copy, so run it on
        the transfer pool or where a wait is intended."""
        flat, lay = self._gather(slot, rows)
        if self.device.type != "cuda":
            return lambda: self._views(flat, lay)
        ex = self.executor
        stage = self._acquire_stage()
        dst = stage[:flat.numel()]
        ev = ex.d2h([(dst, flat)])

        def finish():
            try:
                ex.timed_fetch(ev)
                host = dst.clone()
            finally:
                self._release_stage(stage)
            return self._views(host, lay)

        return finish

    def demote(self, slot, tokens):
        """Copy ``slot``'s registered prefix KV out of the pool and register
        it in the store under ``tokens`` (called by
        ``RadixPrefixCache.evict_lru`` BEFORE the registration is removed).
        The rows are gathered now; the fetch and the store put ride the
        bounded async window."""
        m = len(tokens)
        if m < max(self.sched.prefill_chunk, self.min_restore_tokens, 1):
            # below the restore threshold it could never be restored (the
            # match rounds to chunk multiples and honors min_restore_tokens)
            return
        version = int(self.kv.weights_version)
        finish = self._copy_out(slot, m)
        key = tuple(int(t) for t in tokens)

        def fetch():
            self.store.put(key, finish(), version, origin=id(self))
            self.demotes += 1
            tel = self.sched.telemetry
            if tel.enabled:
                tel.counter("serving/prefix_cache_demote")

        self.executor.submit_fetch(fetch)

    # ------------------------------------------------------------------ probe
    def probe(self, tokens, drain=True):
        """Longest host-tier prefix of ``tokens`` under the scheduler's
        weights version: ``(matched_len, entry)`` or ``(0, None)``. With
        ``drain``, a MISS joins in-flight demotes and probes again (a prefix
        demoted moments ago must be visible); a hit skips the join. The
        submit-time look-ahead passes ``drain=False``."""
        m, entry = self.store.probe(tokens, self.kv.weights_version)
        if drain and entry is None and self.executor._fetches:
            self.executor.drain_fetches()
            m, entry = self.store.probe(tokens, self.kv.weights_version)
        return m, entry

    def prefetch(self, tokens):
        """Submit-time look-ahead: when the prompt's best host match is
        NVMe-spilled, start its disk read now (the restore joins it)."""
        m, entry = self.probe(tokens, drain=False)
        if entry is not None and entry.spill_path is not None:
            self.store.prefetch(entry)
        return m, entry

    # ------------------------------------------------------------------ restore
    def restore(self, entry, slot, matched, prompt_len):
        """Install ``entry``'s rows ``[0, matched)`` at ``slot`` (``matched``
        already chunk-rounded by the scheduler). The entry is CONSUMED
        unless it is strictly longer than the restoring prompt: then its
        cached tail outlives this partial restore. Returns False only when
        a concurrent claim took the entry first (the caller prefills
        cold)."""
        leaves = self.store.pop(entry, consume=entry.length <= int(prompt_len))
        if leaves is None:
            return False
        self._install(leaves, slot, matched)
        self.restores += 1
        self.restored_tokens += int(matched)
        return True

    def _install(self, leaves, slot, rows):
        """Pack ``leaves``' first ``rows`` rows into the persistent staging,
        put them to the device in one copy and write them into ``slot``
        after the compute stream has waited on the put. Pure transfer: no
        counters."""
        if self._restore_stage is None:
            self._restore_stage = self._host_buffer(self._layout(self.kv.max_len)[1])
        n = min([int(rows)] + [int(x.shape[-2]) for x in leaves])
        lay, total = self._layout(n)
        flat = self._restore_stage[:total]
        for dst, src in zip(self._views(flat, lay), leaves):
            dst.copy_(src[..., :n, :])
        self._pending = flat
        dev = self.executor.take("restore")["kv"]  # depth 0: fenced on return
        self._pending = None
        for leaf, src in zip(self._leaves(), self._views(dev, lay)):
            leaf[slot:slot + 1][..., :n, :].copy_(src)

    def _dispatch_restore(self, name):
        return {"kv": self._pending.to(self.device, non_blocking=True)}

    # ------------------------------------------------------------------ migration
    # The prefill->decode handoff of disaggregated serving (the scheduler's
    # migrate_out / admit_migration, ROADMAP Queue 1 #9) parks a request's
    # whole KV in the store through these two, on the same staging and
    # install as the prefix tier: a synthetic negative-sentinel key, the
    # entry pinned until the decode side claims it.
    def demote_request(self, slot, rows, key, on_ready):
        """Copy ``slot``'s first ``rows`` KV rows out of the pool and park
        them in the store under ``key``, pinned. The rows are gathered now
        (the slot may be released at once); the fetch and the put ride the
        bounded async window, and ``on_ready(entry)`` fires from the
        transfer thread once the entry is visible, ``on_ready(None)`` when
        the fetch failed (the caller fails the request)."""
        version = int(self.kv.weights_version)
        finish = self._copy_out(slot, rows)

        def fetch():
            try:
                entry = self.store.put(key, finish(), version, origin=id(self), pinned=True,
                                       length=rows)
            except Exception:  # noqa: BLE001 — surfaced as a failed handoff
                # on_ready(None) fails THIS request; re-raising would poison
                # the shared window at an unrelated drain
                from ..utils.logging import logger
                logger.warning("KV handoff demote fetch failed", exc_info=True)
                on_ready(None)
                return
            on_ready(entry)

        self.executor.submit_fetch(fetch)

    def restore_request(self, entry, slot, rows):
        """Install a parked request's ``entry`` at ``slot`` (rows
        ``[0, rows)``) and consume it. False when the entry was already
        claimed or dropped (the caller fails the request rather than decode
        on vanished KV)."""
        leaves = self.store.pop(entry, consume=True)
        if leaves is None:
            return False
        self._install(leaves, slot, rows)
        return True

    # ------------------------------------------------------------------ extent paging
    # Long-context cold-range demotion (``DecodeScheduler.demote_cold_extents``):
    # a live multi-extent request pages whole EXTENTS (pool rows) to the
    # store mid-decode and restores them on the detect-miss path; synchronous
    # both ways, since the scheduler parks the row until every extent is back.
    def demote_extent(self, pool_slot, key):
        """Copy pool row ``pool_slot``'s full extent to the store under the
        scheduler's synthetic ``key`` (a negative-sentinel tuple no prompt
        can collide with) and return the PINNED entry. The rows are taken
        into fresh memory on the compute stream first, so the caller may
        free the row at once."""
        version = int(self.kv.weights_version)
        host = self._copy_out(pool_slot, self.kv.max_len)()
        self.demotes += 1
        return self.store.put(key, host, version, origin=id(self), pinned=True,
                              length=self.kv.max_len)

    def restore_extent(self, entry, pool_slot):
        """Install a demoted extent's rows back at ``pool_slot`` and consume
        the entry. False when the entry vanished: impossible while the
        owning request is live, so the scheduler raises on it."""
        leaves = self.store.pop(entry, consume=True)
        if leaves is None:
            return False
        self._install(leaves, pool_slot, self.kv.max_len)
        self.restores += 1
        return True

    def warmup(self):
        """Allocate the staging ahead of the first real demote/restore by
        round-tripping slot 0's rows onto themselves (a byte-identical
        self-copy, safe even mid-decode)."""
        self._install(self._copy_out(0, self.kv.max_len)(), 0, self.kv.max_len)

    def discard_exact(self, tokens):
        """Drop this scheduler's own host entry for an exact key about to be
        device-registered (a cold or device-hit prefill superseded it):
        holding both copies would break the one-tier-per-key invariant."""
        self.executor.drain_fetches()
        self.store.discard(tokens, origin=id(self))

    # ------------------------------------------------------------------ invariants
    def invalidate(self):
        """Weight-swap path (through ``RadixPrefixCache.invalidate_all``,
        before the pool version bumps): join in-flight demotes, then drop
        every store entry of the outgoing version. Returns prefix tokens
        dropped from the host tier."""
        self.executor.drain_fetches()
        self.executor.invalidate()
        return self.store.drop_version(self.kv.weights_version)

    def check_invariants(self, radix):
        """Tier half of ``RadixPrefixCache.check_invariants``: no prefix may
        be device-registered in ``radix`` and host-demoted BY THIS
        SCHEDULER under the same key at once (another scheduler's copy is
        legal)."""
        self.executor.drain_fetches()
        for slot in radix.registered_slots():
            tokens = radix.registered_tokens(slot)
            if self.store.contains_exact(tokens, origin=id(self)):
                raise AssertionError(f"prefix of slot {slot} is device-registered AND host-"
                                     f"demoted by the same scheduler (key length {len(tokens)})")

    def hit_rate(self, radix):
        """Combined tier hit rate: (device hits + host restores) over every
        admission that probed (the ``serving/kv_tier_hit_rate`` gauge)."""
        total = radix.hits + radix.misses + self.restores
        return (radix.hits + self.restores) / total if total else 0.0

    def stats(self):
        return {"demotes": self.demotes, "restores": self.restores,
                "restored_tokens": self.restored_tokens, "store": self.store.stats()}
