"""Fleet-global host/NVMe prefix KV store.

Port of ``deepspeed_tpu/memory/prefix_store.py``: the host tier of the
hierarchical KV subsystem (Mooncake-style KV-centric serving). Prefix KV
that the device-side radix cache evicts is DEMOTED here instead of
destroyed, and admission on any scheduler holding this store restores it.

Entries are keyed by their full token sequence in a path-compressed token
trie (the host-tier analogue of
:class:`~deepspeed_tpu_torch.inference.kv_cache.RadixPrefixCache`, minus
the slot pool: entries own host copies of their KV rows). ``probe`` walks
the longest registered prefix of a prompt; ``pop`` hands the entry's rows
to the restoring scheduler and drops the registration, so a prefix lives
in EXACTLY ONE tier at a time: device-cached (radix trie), host-resident
(here), or NVMe-spilled (here, rows on disk).

Entries hold CPU torch tensors (numpy has no bfloat16). Every entry
carries the ``weights_version`` its rows were computed under; probing
against a different version is a STRUCTURAL error: the weight-swap path
drops this store's entries before the pool version bumps, so a surviving
stale entry means that protocol was skipped, not that a cache went cold.

Capacity: host residency is bounded by ``capacity_bytes`` (LRU). With
``nvme_path`` set, over-budget entries SPILL their rows to disk, one flat
file per entry (each leaf's raw bytes in order, written through the
``ops/aio`` handle from a 4096-aligned buffer, so the bulk takes
``O_DIRECT``), instead of dropping; restores read them back through an
:class:`~deepspeed_tpu_torch.runtime.swap_tensor.read_window.AioReadWindow`
slot, and a submit-time ``prefetch`` overlaps the NVMe read with the
request's queue wait. Without ``nvme_path``, over-budget entries are
dropped (recompute is the spill tier).

Thread-safety: every mutation holds the store lock; demotes land from
transfer-pool threads while the scheduler's pump probes and pops.
"""

import os
import threading

import torch

from ..ops.aio import AsyncIOHandle, aligned_empty
from ..runtime.swap_tensor.read_window import AioReadWindow

_AIO_KW = dict(block_size=1 << 20, queue_depth=8, single_submit=False, overlap_events=True,
               thread_count=2)


def _itemsize(dtype):
    return torch.empty(0, dtype=dtype).element_size()


class _Node:
    __slots__ = ("edge", "children", "entries", "parent")

    def __init__(self, edge=(), parent=None):
        self.edge = edge
        self.children = {}
        self.entries = set()
        self.parent = parent


class PrefixEntry:
    """One demoted prefix: token key + host (or NVMe-spilled) KV rows.

    ``leaves`` is the flat list of per-pool-leaf CPU tensors, each cut to
    the prefix's ``length`` rows on the row axis (``ndim - 2``); ``None``
    while the rows live on NVMe (``spill_path``, with ``_meta`` holding
    each leaf's ``(shape, torch.dtype)``). ``origin`` identifies the tier
    client that demoted it (the cross-tier invariant is scoped per
    scheduler). ``pinned`` entries are exempt from LRU capacity
    enforcement: a long-context extent page must survive until its request
    restores it."""

    __slots__ = ("eid", "key", "length", "version", "origin", "leaves", "nbytes", "spill_path",
                 "_meta", "node", "pinned")

    def __init__(self, eid, key, length, version, origin, leaves, pinned=False):
        self.eid = eid
        self.key = key
        self.length = int(length)
        self.version = int(version)
        self.origin = origin
        self.leaves = leaves
        self.nbytes = int(sum(x.nbytes for x in leaves))
        self.spill_path = None
        self._meta = None
        self.node = None
        self.pinned = bool(pinned)


class GlobalPrefixStore:
    """Host tier over demoted prefix KV (see the module docstring).

    ``capacity_bytes`` bounds HOST-resident rows (LRU beyond it spills to
    ``nvme_path`` or drops); ``telemetry`` is an optional sink for the
    ``serving/prefix_cache_spill`` counter and the
    ``serving/kv_host_tier_bytes`` gauge (demote/restore counters come from
    the scheduler-side :class:`~deepspeed_tpu_torch.memory.kv_tier.KVTier`,
    which knows the request context)."""

    def __init__(self, capacity_bytes=256 << 20, nvme_path=None, telemetry=None, nvme_window=2):
        self.capacity_bytes = int(capacity_bytes)
        self.nvme_path = nvme_path
        self.telemetry = telemetry
        self._lock = threading.RLock()
        self._root = _Node()
        self._by_key = {}     # token tuple -> PrefixEntry
        self._lru = {}        # eid -> tick
        self._tick = 0
        self._eid = 0
        self.host_bytes = 0   # host-RESIDENT bytes (spilled rows excluded)
        self.nvme_bytes = 0
        # lifetime counters (per-scheduler counts live on KVTier)
        self.demotes = 0
        self.restores = 0
        self.spills = 0
        self.nvme_loads = 0
        self.dropped = 0      # entries dropped for capacity (no NVMe tier)
        self.nvme_bytes_written = 0
        self.nvme_bytes_read = 0
        self.prefetches_landed = 0  # loads that found their look-ahead read issued
        self._nvme_window = max(1, int(nvme_window))
        self._window = None   # AioReadWindow, built on the first spilled read
        self._write_h = None  # shared spill-write AIO handle
        # spill writes run OUTSIDE the store lock (a write under it would
        # stall every probe); this serializes the shared write handle
        self._io_lock = threading.Lock()
        self._pending_spill = {}  # eid -> flat bytes until the write lands
        self._reads = {}      # eid -> in-flight look-ahead read slot
        if nvme_path:
            os.makedirs(nvme_path, exist_ok=True)

    # ------------------------------------------------------------------ trie
    @staticmethod
    def _common(edge, tokens, depth):
        n = min(len(edge), len(tokens) - depth)
        m = 0
        while m < n and edge[m] == tokens[depth + m]:
            m += 1
        return m

    def _insert_node(self, tokens):
        node, depth = self._root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                new = _Node(edge=tokens[depth:], parent=node)
                node.children[tokens[depth]] = new
                return new
            m = self._common(child.edge, tokens, depth)
            if m < len(child.edge):
                mid = _Node(edge=child.edge[:m], parent=node)
                node.children[tokens[depth]] = mid
                child.edge = child.edge[m:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node, depth = mid, depth + m
            else:
                node, depth = child, depth + m
        return node

    def _prune(self, node):
        while node is not self._root and not node.entries and not node.children:
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    # ------------------------------------------------------------------ put
    def put(self, tokens, leaves, version, origin=None, pinned=False, length=None):
        """Register a demoted prefix (CPU tensors of its KV rows, already
        cut to the prefix length; the store keeps them, copying only a
        non-contiguous one). An exact-key re-demote replaces the older
        entry (freshest rows win); over-budget host bytes spill or drop
        LRU-first. Returns the entry. ``length`` overrides the recorded
        token length when the key is not the row-for-row token sequence
        (extent pages key on a synthetic sentinel tuple)."""
        key = tuple(int(t) for t in tokens)
        with self._lock:
            old = self._by_key.get(key)
            if old is not None:
                self._drop_entry(old)
            self._eid += 1
            entry = PrefixEntry(f"pfx{self._eid}", key, len(key) if length is None else length,
                                version, origin, [x.contiguous() for x in leaves], pinned=pinned)
            node = self._insert_node(key)
            node.entries.add(entry)
            entry.node = node
            self._by_key[key] = entry
            self._touch(entry)
            self.host_bytes += entry.nbytes
            self.demotes += 1
            to_write = self._enforce_capacity()
            self._gauge()
        for victim, flat in to_write:
            self._write_spill(victim, flat)
        return entry

    def _touch(self, entry):
        self._tick += 1
        self._lru[entry.eid] = self._tick

    def _enforce_capacity(self):
        """LRU host residents past the budget SPILL (NVMe tier) or drop.
        Runs under the store lock; the spill metadata flips here and the
        file writes are handed back to :meth:`put` to run unlocked; until
        a write lands, ``_pending_spill`` serves the bytes."""
        to_write = []
        while self.host_bytes > self.capacity_bytes:
            resident = [e for e in self._by_key.values() if e.leaves is not None and not e.pinned]
            if len(resident) <= 1:
                break  # never evict the entry being demoted right now
            victim = min(resident, key=lambda e: self._lru.get(e.eid, 0))
            if self.nvme_path:
                # a 4096-aligned flat buffer: the aio pool moves its
                # aligned bulk through O_DIRECT and only the tail buffered
                flat = aligned_empty(victim.nbytes, torch.uint8)
                off = 0
                for x in victim.leaves:
                    flat[off:off + x.nbytes].copy_(x.reshape(-1).view(torch.uint8))
                    off += x.nbytes
                victim._meta = [(tuple(x.shape), x.dtype) for x in victim.leaves]
                victim.spill_path = os.path.join(self.nvme_path, f"{victim.eid}.kv")
                victim.leaves = None
                self._pending_spill[victim.eid] = flat
                self.host_bytes -= victim.nbytes
                self.nvme_bytes += victim.nbytes
                self.spills += 1
                tel = self.telemetry
                if tel is not None and tel.enabled:
                    tel.counter("serving/prefix_cache_spill")
                to_write.append((victim, flat))
            else:
                self._drop_entry(victim)
                self.dropped += 1
        return to_write

    # ------------------------------------------------------------------ spill
    def _write_spill(self, entry, flat):
        """Land one spill file (OUTSIDE the store lock). If the entry was
        dropped or claimed while the write was pending, the file is
        removed instead of leaking."""
        path = entry.spill_path
        if path is None:
            return
        with self._io_lock:
            if self._write_h is None:
                self._write_h = AsyncIOHandle(**_AIO_KW)
            if flat.numel():
                self._write_h.async_pwrite(flat, path)
                self._write_h.wait()
            else:
                open(path, "wb").close()
        with self._lock:
            self.nvme_bytes_written += flat.numel()
            self._pending_spill.pop(entry.eid, None)
            if self._by_key.get(entry.key) is not entry or entry.spill_path != path:
                try:  # entry died mid-write: reclaim the orphan file
                    os.unlink(path)
                except OSError:
                    pass

    def _get_window(self):
        if self._window is None:
            self._window = AioReadWindow(self._nvme_window, _AIO_KW)
        return self._window

    @staticmethod
    def _slot_bytes(slot, entry):
        """The first ``entry.nbytes`` bytes of ``slot``'s persistent
        aligned buffer (fp32-granular, so reused across entry sizes)."""
        return slot.buffers(-(-entry.nbytes // 4), 1)[0].view(torch.uint8)[:entry.nbytes]

    def _issue_read(self, slot, entry):
        if entry.nbytes:
            slot.handle.async_pread(self._slot_bytes(slot, entry), entry.spill_path)

    def prefetch(self, entry):
        """NVMe look-ahead: issue the async read of a spilled entry's rows
        into a window slot (the submit-time call: the read overlaps the
        request's queue wait, and the restore's load joins it). No-op for
        host-resident or write-pending entries; when every slot is held by
        an earlier UNCLAIMED look-ahead, the oldest is reclaimed: advisory
        reads must never strand the window."""
        with self._lock:
            if (entry.spill_path is None or entry.eid in self._reads
                    or entry.eid in self._pending_spill):
                return
            win = self._get_window()
            slot = win.acquire()
            if slot is None and self._reads:
                eid, old = next(iter(self._reads.items()))
                del self._reads[eid]
                old.handle.wait()
                win.release(old)
                slot = win.acquire()
            if slot is None:
                return
            self._issue_read(slot, entry)
            self._reads[entry.eid] = slot

    def _load(self, entry):
        """Rows of a spilled entry back into CPU tensors: from the
        pending-spill buffer while the file write has not landed, else by
        joining the look-ahead read or reading now through a window
        slot."""
        pending = self._pending_spill.get(entry.eid)
        slot = self._reads.pop(entry.eid, None)
        if pending is not None:
            raw = pending
            if slot is not None:  # a racing look-ahead: fence and return it
                slot.handle.wait()
                self._window.release(slot)
                slot = None
        else:
            if slot is not None:
                self.prefetches_landed += 1
            else:
                slot = self._get_window().acquire()
                if slot is not None:
                    self._issue_read(slot, entry)
            if slot is not None:
                slot.handle.wait()
                raw = self._slot_bytes(slot, entry)
            else:  # window exhausted by concurrent look-aheads: plain read
                with open(entry.spill_path, "rb") as f:
                    raw = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)
            self.nvme_bytes_read += entry.nbytes
        leaves, off = [], 0
        for shape, dtype in entry._meta:
            n = 1
            for d in shape:
                n *= int(d)
            k = n * _itemsize(dtype)
            leaves.append(raw[off:off + k].clone().view(dtype).reshape(shape))
            off += k
        if slot is not None:
            self._window.release(slot)
        self.nvme_loads += 1
        return leaves

    # ------------------------------------------------------------------ probe/pop
    def probe(self, tokens, version):
        """Longest registered prefix of ``tokens``: ``(matched_len, entry)``
        or ``(0, None)``; the MRU entry in the deepest matched subtree wins.
        An entry stamped with a DIFFERENT weights version raises: stale host
        KV surviving a weight swap means the invalidation was skipped."""
        tokens = tuple(int(t) for t in tokens)
        with self._lock:
            node, depth = self._root, 0
            while depth < len(tokens):
                child = node.children.get(tokens[depth])
                if child is None:
                    break
                m = self._common(child.edge, tokens, depth)
                depth += m
                node = child
                if m < len(child.edge):
                    break
            if depth == 0:
                return 0, None
            best, best_tick = None, -1
            stack = [node]
            while stack:
                n = stack.pop()
                for e in n.entries:
                    if e.version != int(version):
                        raise ValueError(
                            f"prefix store entry {e.eid} stamped weights_version {e.version} "
                            f"probed under version {int(version)}: stale host-tier KV must be "
                            f"invalidated by the weight-swap protocol before it can be observed")
                    if self._lru.get(e.eid, 0) > best_tick:
                        best, best_tick = e, self._lru.get(e.eid, 0)
                stack.extend(n.children.values())
            if best is None:
                return 0, None
            self._touch(best)
            return min(depth, best.length), best

    def pop(self, entry, consume=True):
        """Claim ``entry`` for restoration: return its host rows (loaded
        from NVMe when spilled). ``consume`` drops the registration (the
        one-tier-per-key move); the tier passes ``consume=False`` when the
        restoring prompt is STRICTLY SHORTER than the entry, so the longer
        cached tail survives the partial restore. Returns None when a
        concurrent claim already took the entry."""
        with self._lock:
            if self._by_key.get(entry.key) is not entry:
                return None
            leaves = entry.leaves if entry.leaves is not None else self._load(entry)
            if consume:
                self._drop_entry(entry, keep_leaves=leaves)
            else:
                self._touch(entry)
            self.restores += 1
            self._gauge()
            return leaves

    def _drop_entry(self, entry, keep_leaves=None):
        node = entry.node
        node.entries.discard(entry)
        self._by_key.pop(entry.key, None)
        self._lru.pop(entry.eid, None)
        self._prune(node)
        if entry.spill_path is not None:
            self.nvme_bytes -= entry.nbytes
            self._pending_spill.pop(entry.eid, None)
            slot = self._reads.pop(entry.eid, None)
            if slot is not None:  # fence the in-flight look-ahead first
                slot.handle.wait()
                self._window.release(slot)
            try:
                os.unlink(entry.spill_path)
            except OSError:
                pass
            entry.spill_path = None
        elif entry.leaves is not None:
            self.host_bytes -= entry.nbytes
        entry.leaves = keep_leaves

    def discard(self, tokens, origin=None):
        """Drop the exact-key entry (only when ``origin`` matches, if
        given). Returns True when an entry was dropped."""
        with self._lock:
            e = self._by_key.get(tuple(int(t) for t in tokens))
            if e is None or (origin is not None and e.origin != origin):
                return False
            self._drop_entry(e)
            self._gauge()
            return True

    # ------------------------------------------------------------------ invalidation
    def drop_version(self, version):
        """Drop every entry stamped ``version`` (the weight-swap path,
        through ``RadixPrefixCache.invalidate_all``). Returns the number of
        prefix tokens dropped."""
        with self._lock:
            dropped = 0
            for entry in [e for e in self._by_key.values() if e.version == int(version)]:
                dropped += entry.length
                self._drop_entry(entry)
            self._gauge()
            return dropped

    def drop_prefix(self, namespace):
        """Drop every entry whose key starts with ``namespace`` (a key
        namespace scopes all its prefixes). Returns the number of prefix
        tokens dropped."""
        ns = tuple(int(t) for t in namespace)
        if not ns:
            return 0
        with self._lock:
            dropped = 0
            for entry in [e for e in self._by_key.values() if e.key[:len(ns)] == ns]:
                dropped += entry.length - len(ns)
                self._drop_entry(entry)
            self._gauge()
            return dropped

    def clear(self):
        with self._lock:
            for entry in list(self._by_key.values()):
                self._drop_entry(entry)
            self._gauge()

    # ------------------------------------------------------------------ introspection
    def get_exact(self, tokens):
        """The exact-key entry, or None; touches its LRU recency (the
        caller is about to read it: ``net_store.py``'s owner-side fetch)."""
        with self._lock:
            e = self._by_key.get(tuple(int(t) for t in tokens))
            if e is not None:
                self._touch(e)
            return e

    def contains_exact(self, tokens, origin=None):
        """Exact-key registration check (the tier invariant: a scheduler
        never holds a prefix on device while ITS OWN demoted copy of the
        same key sits here)."""
        with self._lock:
            e = self._by_key.get(tuple(int(t) for t in tokens))
            if e is None:
                return False
            return origin is None or e.origin == origin

    def __len__(self):
        with self._lock:
            return len(self._by_key)

    def tokens_resident(self):
        with self._lock:
            return sum(e.length for e in self._by_key.values())

    def stats(self):
        with self._lock:
            return {"entries": len(self._by_key),
                    "tokens": sum(e.length for e in self._by_key.values()),
                    "host_bytes": self.host_bytes, "nvme_bytes": self.nvme_bytes,
                    "demotes": self.demotes, "restores": self.restores, "spills": self.spills,
                    "nvme_loads": self.nvme_loads, "dropped": self.dropped}

    def io_stats(self):
        """NVMe traffic: bytes written and read, loads whose look-ahead
        read was already issued, and the aio pools' ``O_DIRECT`` and
        buffered bytes (write handle and read window summed)."""
        with self._lock:
            out = {"nvme_bytes_written": self.nvme_bytes_written,
                   "nvme_bytes_read": self.nvme_bytes_read,
                   "prefetches_landed": self.prefetches_landed}
        pools = []
        if self._write_h is not None:
            pools.append(self._write_h.io_stats())
        if self._window is not None:
            pools.append(self._window.io_stats())
        for k in ("direct_read", "direct_write", "buffered_read", "buffered_write"):
            out[k] = sum(p.get(k, 0) for p in pools)
        return out

    def _gauge(self):
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.gauge("serving/kv_host_tier_bytes", float(self.host_bytes))
