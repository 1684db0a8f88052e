"""The hierarchical KV tier's copies on the card (``memory/kv_tier.py``):
the pinned device-to-host and host-to-device fences, with the compute
stream kept busy so that a missing fence shows. A demote's fetch must wait
for its copy before it reads the staging, and the copy must read the
rows gathered before the slot was rewritten; a restore's staging must not
be rewritten before the put that reads it has completed. Marked ``cuda``
and skipped without a card; on the card, from the repo root:
``python -m pytest --noconftest -q -m cuda tests/test_torch_kv_tier_cuda.py``.
No JAX here (the card machine has none)."""

import threading
import types

import pytest
import torch

from deepspeed_tpu_torch.inference.kv_cache import SlotKVCache
from deepspeed_tpu_torch.memory import GlobalPrefixStore, KVTier

pytestmark = pytest.mark.cuda

BUSY = 100_000_000  # cycles of torch.cuda._sleep: ~50 ms of busy compute stream


@pytest.fixture
def tier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy streams and pinned buffers exist only there")
    dev = torch.device("cuda")
    shape = (3, 4, 512, 64)  # slots, kv heads, rows, head dim
    pool = tuple((torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                  torch.zeros(shape, dtype=torch.bfloat16, device=dev)) for _ in range(4))
    kv = SlotKVCache(pool, 3, 512)
    sched = types.SimpleNamespace(cache=kv, device=dev, prefill_chunk=64,
                                  telemetry=types.SimpleNamespace(enabled=False))
    t = KVTier(sched, GlobalPrefixStore(capacity_bytes=1 << 30))
    t.executor.time_transfers = True
    return t


def _pinned(bufs):
    """Each staging buffer is page-locked: registered with cudaHostRegister
    at its size (``runtime/zero/offload.host_buffer``; ``is_pinned`` sees
    only the pinned allocator's blocks), or from the pinned allocator where
    registration failed."""
    from deepspeed_tpu_torch.runtime.zero.offload import PINNED
    unregistered = [b for b in bufs if not b.is_pinned()]
    return PINNED["registered"] >= sum(b.numel() for b in unregistered)


def _fill(tier, slot, value):
    for comp in tier.kv.pool:
        for leaf in comp:
            leaf[slot].fill_(value)


def test_demote_fetch_waits_for_its_copy_of_the_gathered_rows(tier):
    """Behind a busy compute stream: the slot is filled, demoted, and
    rewritten by the next admission; the entry holds the rows as filled
    (not the staging's zeros, not the rewrite), in pinned staging."""
    tokens = list(range(256))
    torch.cuda._sleep(BUSY)
    _fill(tier, 0, 1.5)
    gate = threading.Event()
    submit = tier.executor.submit_fetch
    tier.executor.submit_fetch = lambda fn: submit(lambda: (gate.wait(30), fn()))
    tier.demote(0, tokens)
    _fill(tier, 0, -2.0)  # the admission's prefill, behind the gather
    gate.set()
    tier.executor.drain_fetches()
    entry = tier.store.get_exact(tokens)
    assert entry is not None and len(entry.leaves) == 8
    for leaf in entry.leaves:
        assert leaf.shape == (1, 4, 256, 64) and bool((leaf == 1.5).all())
    assert _pinned(tier._stages)
    kind, nbytes, start, end = tier.executor.transfer_events[-1]
    assert kind == "d2h" and nbytes == entry.nbytes and start.elapsed_time(end) > 0


def test_restore_staging_is_not_rewritten_before_its_put_completes(tier):
    """Two restores back to back behind a busy compute stream, each
    rewriting the one persistent staging: each slot gets its own entry's
    rows."""
    a = [torch.full((1, 4, 512, 64), 3.0, dtype=torch.bfloat16) for _ in range(8)]
    b = [torch.full((1, 4, 512, 64), -7.0, dtype=torch.bfloat16) for _ in range(8)]
    torch.cuda._sleep(BUSY)
    tier._install(a, 1, 512)
    tier._install(b, 2, 512)
    assert _pinned([tier._restore_stage]) and tier.staging_allocs == 1
    for comp in tier.kv.pool:
        for leaf in comp:
            assert bool((leaf[1] == 3.0).all()) and bool((leaf[2] == -7.0).all())
    kinds = [k for k, *_ in tier.executor.transfer_events]
    assert kinds == ["h2d", "h2d"]
