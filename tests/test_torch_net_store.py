"""The port's networked store shard (``memory/net_store.py``): the
counterparts of the JAX package's net-store tests in
``tests/unit/serving/test_multihost.py`` (the directory's longest-prefix
probe, its worker drop, the leaf serialization, the handoff lease, plain
puts without a lease, extent pages never advertised, a dead owner
degrading to a miss), run in-process as the JAX tests run them, plus
the serialization of bf16, fp16 and int8 leaves (bitwise) and a remote pop
served by ``serve_fetch`` behind a stdlib ``http.server`` in the test
(the route the multi-host worker will serve). No JAX here: the store is
host-only, and its JAX counterparts run in that package's suite."""

import http.server
import json
import threading
import time

import pytest
import torch

from deepspeed_tpu_torch.memory.net_store import (_MIG_SENTINEL, NetPrefixStore, RemoteEntry,
                                                  StoreDirectory, deserialize_leaves,
                                                  serialize_leaves)
from deepspeed_tpu_torch.memory.prefix_store import GlobalPrefixStore


def test_directory_longest_prefix_same_version_only():
    d = StoreDirectory()
    d.register("w0", "http://a", (1, 2, 3, 4), 4, 7, 64, False)
    d.register("w1", "http://b", (1, 2), 2, 7, 32, False)
    d.register("w2", "http://c", (1, 2, 3, 4, 5, 6), 6, 9, 96, False)
    hit = d.probe((1, 2, 3, 4, 5, 9), 7)
    assert hit["wid"] == "w0" and hit["match_len"] == 4
    # version 9's longer entry is invisible at version 7
    assert d.probe((1, 2, 3, 4, 5, 6), 7)["wid"] == "w0"
    # a mid-entry divergence is not a usable hit
    d2 = StoreDirectory()
    d2.register("w0", "http://a", (1, 2, 3, 4), 4, 7, 64, False)
    assert d2.probe((1, 2, 9), 7) is None
    # self-exclusion: a shard's own records never probe remote
    assert d.probe((1, 2, 3, 4), 7, exclude_wid="w0")["wid"] == "w1"


def test_directory_drop_worker_and_reregister_semantics():
    d = StoreDirectory()
    d.register("w0", "http://a", (1, 2), 2, 1, 8, False)
    d.register("w1", "http://b", (3, 4), 2, 1, 8, False)
    assert d.drop_worker("w0") == 1
    assert d.probe((1, 2), 1) is None
    assert d.probe((3, 4), 1)["wid"] == "w1"
    assert d.drop(version=1) == 1 and d.stats()["entries"] == 0


def _leaves():
    gen = torch.Generator().manual_seed(4)
    bits = torch.randint(-32768, 32767, (2, 3, 4), generator=gen, dtype=torch.int16)
    return [torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
            (torch.arange(8, dtype=torch.int8) - 4).reshape(2, 4),
            torch.tensor([[1.5, -2.25]], dtype=torch.float16),
            bits.view(torch.bfloat16),  # every bit pattern, NaNs included
            torch.empty((1, 0, 3), dtype=torch.bfloat16)]


def test_serialize_leaves_bitwise_roundtrip():
    leaves = _leaves()
    meta, blob = serialize_leaves(leaves)
    assert json.loads(json.dumps(meta)) == meta  # travels as JSON
    back = deserialize_leaves(meta, blob)
    assert len(back) == len(leaves)
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.contiguous().view(-1).view(torch.uint8) if a.numel() else a,
                           b.view(-1).view(torch.uint8) if b.numel() else b)


def test_lease_expiry_reclaims_orphaned_handoff():
    """An unclaimed handoff is reclaimed on lease expiry (the owner frees
    the pinned rows, the directory record drops) while a claimed one never
    expires."""
    local = GlobalPrefixStore(capacity_bytes=1 << 20)
    directory = StoreDirectory()
    net = NetPrefixStore(local, directory, "w0", "http://127.0.0.1:1", lease_s=0.05)
    leaves = [torch.ones((2, 3), dtype=torch.float32)]
    orphan = (_MIG_SENTINEL, 7, 1)
    claimed = (_MIG_SENTINEL, 7, 2)
    assert net.put(orphan, leaves, 3, origin=1, pinned=True, length=2)
    assert net.put(claimed, [x.clone() for x in leaves], 3, origin=1, pinned=True, length=2)
    assert directory.stats()["handoffs"] == 2
    entry = net.get_exact(claimed)
    assert net.pop(entry, consume=True) is not None
    time.sleep(0.1)
    assert net.reap_expired() == 1          # only the orphan
    assert net.get_exact(orphan) is None    # rows freed
    assert directory.probe(orphan, 3) is None
    assert net.leases_expired == 1
    assert directory.reap() == 0  # router-side reap is idempotent with the owner's


def test_plain_prefix_put_has_no_lease():
    local = GlobalPrefixStore(capacity_bytes=1 << 20)
    directory = StoreDirectory()
    net = NetPrefixStore(local, directory, "w0", "http://127.0.0.1:1", lease_s=0.01)
    assert net.put((10, 11, 12), [torch.ones((3, 2))], 1, origin=1, length=3)
    time.sleep(0.05)
    assert net.reap_expired() == 0
    assert directory.probe((10, 11, 12, 13), 1) is not None
    assert directory.stats()["handoffs"] == 0


def test_pinned_extent_pages_never_advertised():
    local = GlobalPrefixStore(capacity_bytes=1 << 20)
    directory = StoreDirectory()
    net = NetPrefixStore(local, directory, "w0", "http://127.0.0.1:1")
    assert net.put((-5, 1, 2), [torch.ones((2, 2))], 1, origin=1, pinned=True, length=2)
    assert directory.stats()["entries"] == 0


def test_remote_probe_miss_and_fetch_failure_degrade():
    """The directory points at a dead owner: the probe returns a
    RemoteEntry, the pop degrades to None (a miss), never raises."""
    local = GlobalPrefixStore(capacity_bytes=1 << 20)
    directory = StoreDirectory()
    directory.register("w9", "http://127.0.0.1:9", (1, 2, 3), 3, 1, 64, False)
    net = NetPrefixStore(local, directory, "w0", "http://127.0.0.1:1", fetch_timeout_s=0.2)
    m, entry = net.probe((1, 2, 3, 4), 1)
    assert m == 3 and isinstance(entry, RemoteEntry) and entry.leaves is None
    assert net.pop(entry, consume=False) is None
    assert net.net_errors >= 1
    assert net.stats()["remote_probe_hits"] == 1


@pytest.fixture
def owner_server():
    """An owner shard behind a stdlib HTTP server on a free local port,
    answering ``POST /v1/store/fetch`` with ``serve_fetch``'s meta line
    and blob (the worker route's wire format)."""
    directory = StoreDirectory()
    owner = NetPrefixStore(GlobalPrefixStore(capacity_bytes=1 << 20), directory, "w1", None)

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            out = owner.serve_fetch(tuple(body["key"]), consume=bool(body["consume"]))
            if out is None:
                self.send_response(404)
                self.end_headers()
                return
            payload, blob = out
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload) + len(blob)))
            self.end_headers()
            self.wfile.write(payload + blob)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    owner.url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield owner, directory
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_remote_pop_served_by_serve_fetch_over_http(owner_server):
    """A prefix demoted on the owner is probe-visible to another shard
    through the directory; its pop fetches the rows over HTTP bitwise
    (bf16, int8, fp16), a partial pop keeps the owner's entry, a consuming
    one removes it at the owner and from the directory."""
    owner, directory = owner_server
    gen = torch.Generator().manual_seed(9)
    rows = [torch.randn(1, 2, 6, 4, generator=gen).bfloat16(),
            torch.randint(-128, 127, (1, 2, 6, 4), generator=gen, dtype=torch.int8),
            torch.randn(1, 1, 6, 1, generator=gen).half()]
    key = (3, 1, 4, 1, 5, 9)
    owner.put(key, [x.clone() for x in rows], 2, origin=1)
    assert directory.stats()["entries"] == 1
    requester = NetPrefixStore(GlobalPrefixStore(capacity_bytes=1 << 20), directory, "w0",
                               "http://127.0.0.1:1")
    m, entry = requester.probe(key + (2, 6), 2)
    assert m == 6 and isinstance(entry, RemoteEntry) and entry.wid == "w1"
    got = requester.pop(entry, consume=False)
    for a, b in zip(rows, got):
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                  b.view(-1).view(torch.uint8))
    assert owner.local.contains_exact(key) and directory.stats()["entries"] == 1
    got = requester.pop(entry, consume=True)
    assert got is not None and not owner.local.contains_exact(key)
    assert directory.probe(key, 2) is None
    assert requester.remote_restores == 2 and requester.net_bytes_in == owner.net_bytes_out > 0
    assert requester.pop(entry) is None  # the owner answers 404 now: a miss
    assert requester.net_errors == 0
