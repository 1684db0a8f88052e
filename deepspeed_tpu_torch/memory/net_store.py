"""Networked prefix/handoff store: per-host shards + a fleet directory.

Port of ``deepspeed_tpu/memory/net_store.py``; host-only (stdlib
``http.client`` and ``json``, rows as CPU torch tensors). Its callers are
the multi-host router (``serving/router.py``: the directory, the worker
agent that swaps this facade in) and the worker gateway's
``/v1/store/fetch`` route.

The cross-HOST half of the hierarchical KV subsystem (Mooncake-style
KVCache-centric serving across processes): every worker process keeps its
own :class:`~deepspeed_tpu_torch.memory.prefix_store.GlobalPrefixStore` shard —
host RAM + NVMe, the single-host store itself — and a
:class:`NetPrefixStore` facade in front of it that mirrors each shard's
registrations into a fleet **directory** living on the router. A prefix
demoted on host A is then probe-visible to host B: B's probe misses
locally, hits the directory, and the restore fetches the raw KV bytes from
A's shard over a single HTTP round trip. Disaggregated prefill→decode
migration across processes rides the same path — the handoff entry parks
pinned in the prefill worker's shard, the decode worker's
``admit_migration`` pops it remotely, and the weights-version stamp +
pinned-entry protocol stay the consistency contract unchanged.

Ownership and leases:

- Every entry has exactly ONE owner (the shard that demoted it). The
  directory stores metadata only — key, length, version, byte size, owner
  URL — never rows.
- ``pop(consume=True)`` (restore, migration adoption) removes the entry at
  the owner and unregisters it from the directory: a prefix lives in
  EXACTLY ONE tier of ONE host at a time, the same invariant the
  single-host store enforces.
- Pinned **handoff** entries (keys carrying the migration sentinel) carry a
  **lease**: a claim deadline, not a renewable heartbeat. If no decode
  worker claims the handoff before the lease expires — the router died, the
  target pool stayed full, the request was orphaned — the owner reaps it
  (local discard + directory unregister) so a dead migration cannot pin
  host RAM forever. The router's directory reaps expired records
  independently, which also covers the owner-died case.
- Plain prefix entries (radix evictions) register without a lease: they are
  cache, already LRU-bounded by their shard, and reclaiming them is the
  shard's business.
- Pinned NON-handoff entries (long-context extent pages) never register:
  they are slot-local working state, meaningless off-host.

Version semantics differ from the local store in ONE deliberate way: a
directory probe SKIPS different-version entries instead of raising. The
local store's raise is a structural assertion (its clients share one
weight tree, so a stale entry means the swap protocol broke); across hosts
a weight swap propagates worker by worker, and observing a not-yet-dropped
foreign entry mid-swap is a liveness condition, not a protocol violation.

Transport is stdlib ``http.client`` — blocking calls made from scheduler
transfer/pump threads, never from the router's event loop. Any network
failure degrades to a MISS (probe) or a failed restore (pop) and counts in
``net_errors``; the fleet keeps serving with cold prefills.
"""

import json
import threading
import time
import urllib.parse

import torch

from ..utils.logging import logger

# the migration key sentinel of disaggregated serving (defined here, not
# imported from the serving layer, which sits above memory): any key
# containing this token is a prefill->decode handoff, which is what the
# lease protocol governs
_MIG_SENTINEL = -(1 << 30)

_JSON_HEADERS = {"Content-Type": "application/json"}


def _is_handoff_key(key):
    return _MIG_SENTINEL in key


def _ints(tokens):
    """A key as JSON-ready Python ints (a prompt arrives as an int32 array)."""
    return [int(t) for t in tokens]


class RemoteEntry:
    """Directory probe hit: the metadata of an entry owned by ANOTHER
    host's shard. Attribute-compatible with
    :class:`~deepspeed_tpu_torch.memory.prefix_store.PrefixEntry` as far as the
    tier reads it (``key``/``length``/``version``/``nbytes``/``pinned``;
    ``leaves`` is always None — the rows live across the network until
    :meth:`NetPrefixStore.pop` fetches them)."""

    __slots__ = ("eid", "key", "length", "version", "origin", "leaves",
                 "nbytes", "spill_path", "pinned", "url", "wid")

    def __init__(self, key, length, version, nbytes, pinned, url, wid):
        self.eid = None
        self.key = tuple(int(t) for t in key)
        self.length = int(length)
        self.version = int(version)
        self.origin = None
        self.leaves = None
        self.spill_path = None
        self.nbytes = int(nbytes)
        self.pinned = bool(pinned)
        self.url = url
        self.wid = wid


class StoreDirectory:
    """The router-side registry: key -> (owner wid/url, metadata, lease).

    Thread-safe, metadata-only. ``probe`` walks the longest registered
    prefix of a prompt across ALL shards (same-version entries only,
    requester's own entries excluded — its local probe already covered
    those); ``reap`` drops expired handoff leases and everything a dead
    worker owned."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}   # key tuple -> record dict
        self.leases_expired = 0

    def register(self, wid, url, key, length, version, nbytes, pinned,
                 lease_s=None, now=None):
        key = tuple(int(t) for t in key)
        rec = {"wid": wid, "url": url, "key": key, "length": int(length),
               "version": int(version), "nbytes": int(nbytes),
               "pinned": bool(pinned), "expires_at": None}
        if lease_s is not None:
            rec["expires_at"] = (now if now is not None
                                 else time.monotonic()) + float(lease_s)
        with self._lock:
            self._entries[key] = rec

    def unregister(self, key):
        with self._lock:
            return self._entries.pop(tuple(int(t) for t in key), None) is not None

    def probe(self, key, version, exclude_wid=None):
        """Longest same-version prefix match over registered keys. Returns
        the record dict + match length, or None. O(entries) scan — the
        directory holds metadata for at most a few thousand demoted
        prefixes, and the router calls this off the request path only on
        local-probe misses."""
        key = tuple(int(t) for t in key)
        version = int(version)
        best, best_len = None, 0
        with self._lock:
            for rec in self._entries.values():
                if rec["wid"] == exclude_wid or rec["version"] != version:
                    continue
                rkey = rec["key"]
                n = min(len(rkey), len(key))
                m = 0
                while m < n and rkey[m] == key[m]:
                    m += 1
                # a usable hit covers the entry's WHOLE key or a strict
                # prefix of the prompt: partial-key matches (diverging
                # mid-entry) restore rows the prompt doesn't share
                if m < len(rkey) and m < len(key):
                    continue
                depth = min(m, rec["length"])
                if depth > best_len:
                    best, best_len = rec, depth
        if best is None:
            return None
        return dict(best, match_len=best_len)

    def drop_worker(self, wid):
        """A worker died or deregistered: its shard's rows are gone, so
        every directory record pointing at it is garbage."""
        with self._lock:
            stale = [k for k, rec in self._entries.items() if rec["wid"] == wid]
            for k in stale:
                del self._entries[k]
        return len(stale)

    def drop(self, wid=None, version=None, prefix=None):
        """Bulk invalidation mirror of the shard-side drop paths."""
        pre = tuple(int(t) for t in prefix) if prefix else None
        with self._lock:
            stale = [k for k, rec in self._entries.items()
                     if (wid is None or rec["wid"] == wid)
                     and (version is None or rec["version"] == int(version))
                     and (pre is None or k[:len(pre)] == pre)]
            for k in stale:
                del self._entries[k]
        return len(stale)

    def reap(self, now=None):
        """Drop handoff records whose claim lease expired (owner died or
        never reaped). Returns the number dropped."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            stale = [k for k, rec in self._entries.items()
                     if rec["expires_at"] is not None and rec["expires_at"] < now]
            for k in stale:
                del self._entries[k]
            self.leases_expired += len(stale)
        return len(stale)

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries),
                    "handoffs": sum(1 for r in self._entries.values()
                                    if r["expires_at"] is not None),
                    "bytes": sum(r["nbytes"] for r in self._entries.values()),
                    "leases_expired": self.leases_expired}


class DirectoryClient:
    """Blocking HTTP adapter from the worker's shard to the router's
    directory endpoints. Mirrors :class:`StoreDirectory`'s method surface;
    every network failure degrades to a no-op / miss (the fleet must keep
    serving through a router blip) and counts in ``errors``."""

    def __init__(self, router_url, timeout_s=30.0):
        parsed = urllib.parse.urlsplit(router_url)
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self.timeout_s = float(timeout_s)
        self.errors = 0

    def _post(self, path, obj):
        import http.client
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", path, json.dumps(obj).encode(),
                         dict(_JSON_HEADERS))
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise OSError(f"{path} -> HTTP {resp.status}")
            return json.loads(body) if body else {}
        finally:
            conn.close()

    def _try(self, path, obj):
        try:
            return self._post(path, obj)
        except Exception as e:  # noqa: BLE001 — any transport failure degrades
            self.errors += 1
            logger.warning(f"store directory {path} failed: {e}")
            return None

    def register(self, wid, url, key, length, version, nbytes, pinned,
                 lease_s=None, now=None):
        self._try("/v1/store/register",
                  {"wid": wid, "url": url, "key": _ints(key),
                   "length": int(length), "version": int(version),
                   "nbytes": int(nbytes), "pinned": bool(pinned),
                   "lease_s": lease_s})

    def unregister(self, key):
        self._try("/v1/store/unregister", {"key": _ints(key)})

    def probe(self, key, version, exclude_wid=None):
        out = self._try("/v1/store/probe",
                        {"key": _ints(key), "version": int(version),
                         "wid": exclude_wid})
        if not out or not out.get("found"):
            return None
        return out["entry"]

    def drop(self, wid=None, version=None, prefix=None):
        self._try("/v1/store/drop",
                  {"wid": wid, "version": version,
                   "prefix": _ints(prefix) if prefix else None})

    def reap(self, now=None):
        return 0  # the router reaps its own directory


def serialize_leaves(leaves):
    """(meta dict, flat bytes) for one entry's host rows: each CPU tensor's
    raw bytes in order, with its shape and dtype name (``"bfloat16"``,
    ``"int8"``, ...), so the restore side rebuilds the same bits (bf16
    included, which numpy cannot carry)."""
    meta = {"shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype).replace("torch.", "") for x in leaves]}
    blob = b"".join(x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                    for x in leaves)
    return meta, blob


def deserialize_leaves(meta, blob):
    leaves, off = [], 0
    for shape, name in zip(meta["shapes"], meta["dtypes"]):
        out = torch.empty(tuple(shape), dtype=getattr(torch, name))
        n = out.numel() * out.element_size()
        if n:
            raw = torch.frombuffer(bytearray(blob[off:off + n]), dtype=torch.uint8)
            out.view(-1).view(torch.uint8).copy_(raw)
        off += n
        leaves.append(out)
    return leaves


class NetPrefixStore:
    """Network facade over one host's :class:`GlobalPrefixStore` shard.

    Drop-in for the store slot on every local scheduler's
    :class:`~deepspeed_tpu_torch.memory.kv_tier.KVTier` (a multi-host worker
    swaps it in): local puts/probes/pops hit the shard exactly as before
    (zero added latency on the hot local path — directory mirroring runs on
    the same transfer thread that already did the device→host fetch), and
    local probe MISSES fall through to the fleet directory, turning
    cross-host revisits into a network restore instead of a cold prefill.
    """

    def __init__(self, local, directory, wid, url, lease_s=30.0,
                 fetch_timeout_s=30.0, telemetry=None):
        self.local = local
        self.directory = directory
        self.wid = wid
        self.url = url
        self.lease_s = float(lease_s)
        self.fetch_timeout_s = float(fetch_timeout_s)
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._lease_deadlines = {}   # key -> monotonic claim deadline
        self.net_bytes_in = 0
        self.net_bytes_out = 0
        self.remote_restores = 0
        self.remote_probe_hits = 0
        self.leases_expired = 0
        self.net_errors = 0

    # ------------------------------------------------------------------ shard delegation
    def __getattr__(self, name):
        # anything not overridden (host_bytes, capacity_bytes, counters the
        # shard owns) reads straight through to the local shard
        return getattr(self.local, name)

    def __len__(self):
        return len(self.local)

    def put(self, tokens, leaves, version, origin=None, pinned=False,
            length=None):
        entry = self.local.put(tokens, leaves, version, origin=origin,
                               pinned=pinned, length=length)
        if entry is None:
            return None
        if pinned and not _is_handoff_key(entry.key):
            return entry  # extent pages: slot-local, never advertised
        lease = self.lease_s if (pinned and _is_handoff_key(entry.key)) else None
        if lease is not None:
            with self._lock:
                self._lease_deadlines[entry.key] = time.monotonic() + lease
        self.directory.register(self.wid, self.url, entry.key, entry.length,
                                entry.version, entry.nbytes, entry.pinned,
                                lease_s=lease)
        return entry

    def probe(self, tokens, version):
        m, entry = self.local.probe(tokens, version)
        if entry is not None:
            return m, entry
        rec = self.directory.probe(tokens, version, exclude_wid=self.wid)
        if rec is None:
            return 0, None
        self.remote_probe_hits += 1
        remote = RemoteEntry(rec["key"], rec["length"], rec["version"],
                             rec["nbytes"], rec["pinned"], rec["url"],
                             rec["wid"])
        return int(rec["match_len"]), remote

    def pop(self, entry, consume=True):
        if not isinstance(entry, RemoteEntry):
            leaves = self.local.pop(entry, consume=consume)
            if leaves is not None and consume:
                self.directory.unregister(entry.key)
                with self._lock:
                    self._lease_deadlines.pop(entry.key, None)
            return leaves
        return self._fetch_remote(entry, consume)

    def _fetch_remote(self, entry, consume):
        """One HTTP round trip to the owner shard's ``/v1/store/fetch``:
        meta JSON line + raw concatenated leaf bytes. Returns the rebuilt
        host leaves, or None (claimed/evicted/unreachable — the caller
        falls back to cold prefill, exactly the local-race contract)."""
        import http.client
        t0 = time.monotonic()
        parsed = urllib.parse.urlsplit(entry.url)
        try:
            conn = http.client.HTTPConnection(parsed.hostname,
                                              parsed.port or 80,
                                              timeout=self.fetch_timeout_s)
            try:
                conn.request("POST", "/v1/store/fetch",
                             json.dumps({"key": _ints(entry.key),
                                         "consume": bool(consume)}).encode(),
                             dict(_JSON_HEADERS))
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    return None
                raw = resp.read()
            finally:
                conn.close()
        except Exception as e:  # noqa: BLE001 — degrade to cold prefill
            self.net_errors += 1
            logger.warning(f"remote KV fetch from {entry.url} failed: {e}")
            return None
        nl = raw.index(b"\n")
        meta = json.loads(raw[:nl].decode())
        leaves = deserialize_leaves(meta, raw[nl + 1:])
        self.net_bytes_in += len(raw)
        self.remote_restores += 1
        if consume:
            self.directory.unregister(entry.key)
        dt_ms = (time.monotonic() - t0) * 1e3
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.counter("serving/router/store_net_bytes_in", len(raw))
            tel.histogram("serving/router/remote_restore_ms", dt_ms)
        return leaves

    def serve_fetch(self, key, consume=True):
        """Owner-side handler body for ``POST /v1/store/fetch``: look up the
        exact key in the LOCAL shard and return ``(meta_json_bytes, blob)``
        or None. Runs on the gateway's fetch executor thread — ``pop`` may
        do an NVMe load."""
        entry = self.local.get_exact(key)
        if entry is None:
            return None
        leaves = self.local.pop(entry, consume=consume)
        if leaves is None:
            return None
        if consume:
            self.directory.unregister(entry.key)
            with self._lock:
                self._lease_deadlines.pop(entry.key, None)
        meta, blob = serialize_leaves(leaves)
        meta.update(length=entry.length, version=entry.version,
                    nbytes=entry.nbytes)
        payload = json.dumps(meta).encode() + b"\n"
        self.net_bytes_out += len(payload) + len(blob)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.counter("serving/router/store_net_bytes_out",
                        len(payload) + len(blob))
        return payload, blob

    # ------------------------------------------------------------------ leases
    def reap_expired(self, now=None):
        """Owner-side lease enforcement: discard handoff entries nobody
        claimed before their deadline. A lease is a CLAIM deadline, not a
        heartbeat — there is no renewal; an unclaimed handoff is an
        orphaned request and holding its (pinned, capacity-exempt) rows
        any longer just leaks host RAM. Returns the number reaped."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            stale = [k for k, dl in self._lease_deadlines.items() if dl < now]
            for k in stale:
                del self._lease_deadlines[k]
        reaped = 0
        for key in stale:
            if self.local.discard(key):
                reaped += 1
            self.directory.unregister(key)
        self.leases_expired += reaped
        if reaped:
            logger.warning(f"store shard {self.wid}: reaped {reaped} expired "
                           f"handoff lease(s)")
        return reaped

    # ------------------------------------------------------------------ invalidation mirror
    def discard(self, tokens, origin=None):
        dropped = self.local.discard(tokens, origin=origin)
        if dropped:
            key = tuple(int(t) for t in tokens)
            self.directory.unregister(key)
            with self._lock:
                self._lease_deadlines.pop(key, None)
        return dropped

    def drop_version(self, version):
        n = self.local.drop_version(version)
        self.directory.drop(wid=self.wid, version=int(version))
        return n

    def drop_prefix(self, namespace):
        n = self.local.drop_prefix(namespace)
        self.directory.drop(wid=self.wid, prefix=tuple(namespace))
        return n

    def clear(self):
        self.local.clear()
        self.directory.drop(wid=self.wid)
        with self._lock:
            self._lease_deadlines.clear()

    def prefetch(self, entry):
        if isinstance(entry, RemoteEntry):
            return  # no NVMe look-ahead across the network
        self.local.prefetch(entry)

    def contains_exact(self, tokens, origin=None):
        return self.local.contains_exact(tokens, origin=origin)

    def get_exact(self, tokens):
        return self.local.get_exact(tokens)

    def tokens_resident(self):
        return self.local.tokens_resident()

    def stats(self):
        out = self.local.stats()
        out.update(net_bytes_in=self.net_bytes_in,
                   net_bytes_out=self.net_bytes_out,
                   remote_restores=self.remote_restores,
                   remote_probe_hits=self.remote_probe_hits,
                   leases_expired=self.leases_expired,
                   net_errors=self.net_errors
                   + getattr(self.directory, "errors", 0))
        return out
