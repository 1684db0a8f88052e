"""Slot-based paged KV cache for continuous-batching decode, plus the radix
prefix cache that reuses it across requests.

Port of ``deepspeed_tpu/inference/kv_cache.py``. Serving keeps ONE
fixed-shape pool of ``num_slots`` cache slots, per-layer tuples of
(num_slots, kv_heads, max_len, head_dim) tensors (a third tuple of
(num_slots, 1, max_len, 1) fp16 scales on the int8 tier), plus a host-side
row of per-slot lengths. Under tensor parallelism a rank's pool holds its
kv heads (``kv_heads / tp``), and its slots, radix copies and extent chains
follow the same host bookkeeping on every rank; the int8 scale pool stays
whole (one scale a row across every head, the same on every rank). A request claims a free slot, its prompt KV lands in
rows ``[0, len)`` and it rides the shared decode step; on finish the slot
returns to the free list (or, holding a registered prefix, to the
``cached`` state) and the next queued request overwrites it. The paged
kernels walk each row's own window, so attention work scales with live
tokens, not pool capacity.

Cross-request KV reuse (SGLang RadixAttention on the slot pool): a finished
request's slot is retained with its prompt registered in a token trie
(:class:`RadixPrefixCache`); admission copies the longest matched prefix's
rows from the donor slot (:func:`copy_slot`) and prefills only the suffix.
Every slot is stamped with the pool's weights version at :meth:`alloc`, and
registrations carry it too, so KV can never be reused across weights.

Long context: a request longer than one slot claims a CHAIN of pool rows
(extents) at admission, all or nothing (:meth:`SlotKVCache.alloc_chain`);
logical position ``p`` lives in extent ``p // max_len`` at offset
``p % max_len``, and the extent modes of the paged kernels walk the chain
through a per-row extent table. A lossy sliding-window request drops
extents that slide out of its window (:meth:`SlotKVCache.demote_extent`).

Everything here is host bookkeeping except :func:`copy_slot`, an in-place
``copy_`` of one slot's rows in every layer leaf.
"""

import numpy as np


class SlotKVCache:
    """Fixed pool of KV cache slots + free-list allocation with three slot
    states:

    - ``free``   — no meaningful contents; on the free list.
    - ``active`` — owned by a live request (prefilling or decoding).
    - ``cached`` — released by its request but holding a retained prefix the
      radix cache still references (``refs[slot] > 0``); not allocatable
      until :meth:`reclaim` (radix eviction) returns it to the free list.
    - ``extent`` — a secondary row of a long-context extent chain
      (:meth:`alloc_chain`): its KV belongs to the chain's primary slot,
      which alone carries the request's logical length and owner.

    ``pool`` is the device-side cache tree (``model.init_cache(num_slots,
    max_len)``), written in place by the scheduler's steps.
    """

    def __init__(self, pool, num_slots, max_len, max_extents=1):
        self.pool = pool
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        # one request may span up to ``max_extents`` pool rows; its primary
        # row's ``lengths`` entry then counts LOGICAL tokens (up to
        # chain_len * max_len), the other rows sit in the ``extent`` state
        self.max_extents = int(max_extents)
        self.chain = {}  # primary slot -> [primary, ext1, ...]; -1 = dropped
        self.lengths = np.zeros(self.num_slots, np.int32)  # live tokens per slot
        self.state = ["free"] * self.num_slots
        self.refs = np.zeros(self.num_slots, np.int32)  # trie references
        self._free = list(range(self.num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._owner = [None] * self.num_slots  # request id per slot (debugging)
        self.total_allocs = 0
        self.total_frees = 0
        # rows are only meaningful against the weights that computed them
        self.weights_version = 0
        self.slot_version = np.zeros(self.num_slots, np.int64)

    # ------------------------------------------------------------------ alloc
    def alloc(self, owner=None):
        """Claim a free slot (lowest index first) or return None when no
        slot is on the free list (cached slots need a :meth:`reclaim`
        first). The slot's length row resets to 0; stale contents need no
        scrub — the prefill overwrites ``[0, len)`` and per-slot ends mask
        everything past the write head."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.lengths[slot] = 0
        self.state[slot] = "active"
        self._owner[slot] = owner
        self.slot_version[slot] = self.weights_version
        self.total_allocs += 1
        return slot

    def alloc_chain(self, n_ext, owner=None):
        """Claim ``n_ext`` pool rows as ONE logical extent chain for a
        long-context request: the first (primary) row carries the request's
        bookkeeping (logical ``lengths`` row, owner, state ``active``), every
        other row enters the ``extent`` state, off the free list and
        invisible to radix reuse. Returns the primary slot, or None when the
        request exceeds ``max_extents`` or fewer than ``n_ext`` rows are
        free (all or nothing: a partial chain is never claimed)."""
        n_ext = int(n_ext)
        if n_ext <= 1:
            return self.alloc(owner)
        if n_ext > self.max_extents or len(self._free) < n_ext:
            return None
        primary = self.alloc(owner)
        members = [primary]
        for _ in range(n_ext - 1):
            s = self._free.pop()
            self.lengths[s] = 0
            self.state[s] = "extent"
            self._owner[s] = owner
            self.slot_version[s] = self.weights_version
            members.append(s)
        self.chain[primary] = members
        return primary

    def extents(self, slot):
        """Pool rows backing ``slot``'s logical KV in extent order (entry i
        holds logical tokens ``[i*max_len, (i+1)*max_len)``); -1 marks a
        dropped extent. A single-extent slot is its own chain."""
        return self.chain.get(slot, [slot])

    def extent_capacity(self, slot):
        """Logical token capacity of ``slot``'s chain (dropped extents still
        count: their logical range exists, just not on the device)."""
        return len(self.extents(slot)) * self.max_len

    def missing_extents(self, slot):
        """Indices of dropped extents in ``slot``'s chain."""
        return [i for i, s in enumerate(self.extents(slot)) if s < 0]

    def demote_extent(self, primary, idx):
        """Release the pool row behind chain extent ``idx`` of ``primary``
        (the lossy sliding-window mode: its positions are masked out for
        good). The row returns to the free list and the chain marks the
        extent -1. Extent 0 is pinned: it anchors the request's bookkeeping
        row and holds the attention-sink tokens, so only ``idx >= 1``
        demotes. Returns the freed pool row."""
        members = self.chain.get(primary)
        if members is None:
            raise ValueError(f"demote_extent on slot {primary} with no extent chain")
        if not 1 <= int(idx) < len(members):
            raise ValueError(f"extent index {idx} outside chain of {len(members)} "
                             f"(extent 0 is pinned)")
        s = members[int(idx)]
        if s < 0:
            raise ValueError(f"extent {idx} of slot {primary} already demoted")
        self.state[s] = "free"
        self._owner[s] = None
        self._free.append(s)
        members[int(idx)] = -1
        return s

    def restore_extent(self, primary, idx):
        """Re-claim a pool row for a dropped extent. Returns the new pool
        row, or None when the free list is dry."""
        members = self.chain.get(primary)
        if members is None:
            raise ValueError(f"restore_extent on slot {primary} with no extent chain")
        if not 1 <= int(idx) < len(members):
            raise ValueError(f"extent index {idx} outside chain of {len(members)}")
        if members[int(idx)] >= 0:
            raise ValueError(f"extent {idx} of slot {primary} is not demoted")
        if not self._free:
            return None
        s = self._free.pop()
        self.lengths[s] = 0
        self.state[s] = "extent"
        self._owner[s] = self._owner[primary]
        self.slot_version[s] = self.weights_version
        members[int(idx)] = s
        return s

    def free(self, slot):
        """Return an active ``slot`` to the pool (eviction at token-iteration
        granularity: the scheduler calls this the moment a sequence
        finishes, mid-decode-loop), with its whole extent chain; dropped
        (-1) entries hold no pool row and are skipped."""
        if self.state[slot] != "active":
            raise ValueError(f"double free of slot {slot} (state {self.state[slot]})")
        members = self.chain.pop(slot, None)
        if members is not None:
            for s in members[1:]:
                if s < 0:
                    continue
                if self.state[s] != "extent":
                    raise ValueError(f"chain member {s} of slot {slot} in state "
                                     f"{self.state[s]} (extent bookkeeping drift)")
                self.lengths[s] = 0
                self.state[s] = "free"
                self._owner[s] = None
                self._free.append(s)
        self.lengths[slot] = 0
        self.state[slot] = "free"
        self._owner[slot] = None
        self._free.append(slot)
        self.total_frees += 1

    def retain(self, slot):
        """Release an active slot WITHOUT scrubbing: its prefix KV stays
        resident for radix reuse (state ``cached``). Counts as a free for
        the alloc/free ledger, but the slot stays off the free list until
        :meth:`reclaim`."""
        if self.state[slot] != "active":
            raise ValueError(f"retain of non-active slot {slot} (state {self.state[slot]})")
        if slot in self.chain:
            raise ValueError(f"retain of multi-extent slot {slot}: spanned prefixes don't "
                             f"register for radix reuse (free the chain instead)")
        if self.refs[slot] <= 0:
            raise ValueError(f"retain of slot {slot} with no trie reference")
        if self.slot_version[slot] != self.weights_version:
            raise ValueError(f"retain of slot {slot} stamped weights_version "
                             f"{int(self.slot_version[slot])} under pool version "
                             f"{self.weights_version}: KV computed under stale weights must "
                             f"never be retained for reuse")
        self.state[slot] = "cached"
        self._owner[slot] = None
        self.total_frees += 1

    def reclaim(self, slot):
        """Cached -> free: the radix cache evicted the slot's last
        reference; its rows are garbage from here on."""
        if self.state[slot] != "cached":
            raise ValueError(f"reclaim of non-cached slot {slot} (state {self.state[slot]})")
        if self.refs[slot] != 0:
            raise ValueError(f"reclaim of slot {slot} still holding {self.refs[slot]} refs")
        self.lengths[slot] = 0
        self.state[slot] = "free"
        self._free.append(slot)

    def fits(self, prompt_len, max_new_tokens):
        """Would a request of this shape ever fit, spanning up to
        ``max_extents`` chained rows when one extent is not enough?"""
        return prompt_len + max_new_tokens <= self.spannable_len

    def adopt_rows(self, slot, length, version):
        """Account ``length`` KV rows computed elsewhere landing on ACTIVE
        ``slot`` (the disaggregated prefill-to-decode handoff: a decode
        replica installs rows another replica's prefill wrote). The rows'
        ``version`` must be this pool's weights version, the rule the
        retain and insert paths keep."""
        if self.state[slot] != "active":
            raise ValueError(f"adopt_rows on non-active slot {slot} (state {self.state[slot]})")
        if int(version) != self.weights_version:
            raise ValueError(f"adopt_rows of KV stamped weights_version {int(version)} onto a pool at "
                             f"version {self.weights_version}: a migrated request whose weights were "
                             f"swapped mid-handoff must fail, not decode on stale rows")
        cap = self.extent_capacity(slot)
        if not 0 <= int(length) <= cap:
            raise ValueError(f"adopt_rows length {length} outside [0, {cap}]")
        self.lengths[slot] = int(length)
        self.slot_version[slot] = self.weights_version

    @property
    def spannable_len(self):
        """Maximum logical tokens one request can hold across its longest
        permitted extent chain."""
        return self.max_len * self.max_extents

    def extents_needed(self, total_tokens):
        """Chain length a request of ``total_tokens`` logical tokens needs
        (ceil over the per-extent capacity; at least 1)."""
        return max(1, -(-int(total_tokens) // self.max_len))

    # ------------------------------------------------------------------ stats
    @property
    def active_slots(self):
        """Slots owned by LIVE requests (cached prefix slots don't count)."""
        return sum(1 for s in self.state if s == "active")

    @property
    def cached_slots(self):
        return sum(1 for s in self.state if s == "cached")

    @property
    def extent_slots(self):
        """Pool rows serving as secondary extents of long-context chains."""
        return sum(1 for s in self.state if s == "extent")

    @property
    def free_slots(self):
        return len(self._free)

    def occupancy(self):
        """Fraction of slots holding live sequences."""
        return self.active_slots / self.num_slots

    def _tokens(self, state):
        return int(sum(int(self.lengths[i]) for i in range(self.num_slots)
                       if self.state[i] == state))

    def live_tokens(self):
        """Total KV rows backing ACTIVE slots."""
        return self._tokens("active")

    def cached_tokens(self):
        """Total KV rows retained in cached prefix slots."""
        return self._tokens("cached")

    def token_utilization(self):
        """(live + retained) tokens / pool capacity: how much of the
        fixed-shape pool is doing useful work."""
        return ((self.live_tokens() + self.cached_tokens())
                / float(self.num_slots * self.max_len))

    def bytes_per_token(self):
        """Device bytes backing ONE cache row (all layers, K+V, and on the
        int8 tier the per-row scale leaves): every pool leaf keeps its slot
        and row axes, so per-row bytes fall out of the leaf sizes. 0 when
        the pool is host-bookkeeping-only (tests)."""
        if self.pool is None:
            return 0
        denom = self.num_slots * self.max_len
        return int(sum((leaf.numel() // denom) * leaf.element_size()
                       for comp in self.pool for leaf in comp))

    def capacity_bytes(self):
        """Total device bytes held by the fixed-shape pool."""
        return self.bytes_per_token() * self.num_slots * self.max_len

    def live_bytes(self):
        """Bytes backing live + retained rows (the working set; the rest of
        ``capacity_bytes`` is preallocated headroom)."""
        return (self.live_tokens() + self.cached_tokens()) * self.bytes_per_token()

    def check_invariants(self):
        """Every slot is in exactly one state; the free list matches the
        state row; refs only on active/cached slots; every chain leads with
        its active primary, holds distinct ``extent`` rows and no more
        logical tokens than its capacity. Raises on drift."""
        if sorted(self._free) != sorted(i for i, s in enumerate(self.state) if s == "free"):
            raise AssertionError(f"free list {sorted(self._free)} != free states")
        if len(set(self._free)) != len(self._free):
            raise AssertionError("duplicate slots on the free list")
        for i, s in enumerate(self.state):
            if s == "free" and (self.lengths[i] != 0 or self.refs[i] != 0):
                raise AssertionError(f"free slot {i} holds rows/refs")
            if s == "cached" and self.refs[i] <= 0:
                raise AssertionError(f"cached slot {i} holds no reference")
            if s == "cached" and self.slot_version[i] != self.weights_version:
                raise AssertionError(f"cached slot {i} carries weights_version "
                                     f"{int(self.slot_version[i])} != pool version "
                                     f"{self.weights_version} (stale-weights KV retained)")
            if self.refs[i] < 0:
                raise AssertionError(f"negative refcount on slot {i}")
        chained = [s for m in self.chain.values() for s in m[1:] if s >= 0]
        if len(set(chained)) != len(chained):
            raise AssertionError("pool row appears in two extent chains")
        for primary, members in self.chain.items():
            if len(members) < 2 or len(members) > self.max_extents:
                raise AssertionError(f"chain of slot {primary} has bad length {len(members)} "
                                     f"(max_extents {self.max_extents})")
            if members[0] != primary:
                raise AssertionError(f"chain of slot {primary} doesn't lead with it")
            if self.state[primary] != "active":
                raise AssertionError(f"chain primary {primary} is {self.state[primary]}, not active")
            if self.lengths[primary] > len(members) * self.max_len:
                raise AssertionError(f"slot {primary} logical length {int(self.lengths[primary])} "
                                     f"exceeds its chain capacity")
            for s in members[1:]:
                if s < 0:
                    continue  # dropped
                if self.state[s] != "extent":
                    raise AssertionError(f"chain member {s} of slot {primary} is {self.state[s]}, "
                                         f"not extent")
                if self.lengths[s] != 0 or self.refs[s] != 0:
                    raise AssertionError(f"extent row {s} holds its own lengths/refs (belong to "
                                         f"the primary)")
        for i, s in enumerate(self.state):
            if s == "extent" and i not in set(chained):
                raise AssertionError(f"extent-state row {i} belongs to no chain")
        if (self.active_slots + self.cached_slots + self.free_slots + self.extent_slots
                != self.num_slots):
            raise AssertionError("slot states don't partition the pool")


def slot_slice(pool, slot):
    """One slot's cache as a (B=1)-batch cache tree of views into ``pool``."""
    return tuple(tuple(leaf[slot:slot + 1] for leaf in comp) for comp in pool)


def slot_update(pool, slot, slot_cache):
    """Write a (B=1) slot cache into ``pool`` at ``slot``, in place (the
    inverse of :func:`slot_slice`)."""
    for comp, src in zip(pool, slot_cache):
        for leaf, s in zip(comp, src):
            leaf[slot:slot + 1].copy_(s)
    return pool


def copy_slot(pool, src, dst):
    """Duplicate slot ``src``'s rows into slot ``dst`` in every layer leaf,
    in place (radix prefix hit: the donor's retained prefix seeds the new
    request's slot, so only the suffix needs prefilling). Copies the FULL
    slot: rows past the matched prefix are garbage either way (per-slot
    ends mask them until later writes land). ``src == dst`` is a no-op."""
    if src != dst:
        for comp in pool:
            for leaf in comp:
                leaf[dst].copy_(leaf[src])
    return pool


class _RadixNode:
    __slots__ = ("edge", "children", "slots", "parent")

    def __init__(self, edge=(), parent=None):
        self.edge = edge        # token tuple on the edge INTO this node
        self.children = {}      # first token of child edge -> child node
        self.slots = set()      # slots whose retained prefix ends here
        self.parent = parent


class RadixPrefixCache:
    """Token trie (path-compressed radix tree) over retained prompt
    prefixes, mapped onto the slot pool:

    - :meth:`insert` registers a slot's full prompt once its prefill
      completes (live AND finished slots serve as donors — prefill rows are
      never rewritten during decode, so a mid-decode donor is stable).
    - :meth:`match` walks the longest shared prefix of a new prompt and
      returns ``(matched_len, donor_slot)``.
    - :meth:`evict_lru` drops the least-recently-used CACHED slot's
      registration (active slots are pinned by their request) so the
      scheduler can :meth:`SlotKVCache.reclaim` it for admission.

    Each registration holds one reference in ``kv.refs``; eviction releases
    it. With the hierarchical KV tier attached (``tier``, a
    :class:`~deepspeed_tpu_torch.memory.kv_tier.KVTier`), an evicted
    registration's prefix KV DEMOTES to the host store instead of being
    destroyed, and :meth:`invalidate_all` drops the host tier too. The JAX
    package's per-adapter roots (and adapter-scoped host keys) come with
    multi-LoRA (ROADMAP Queue 1 #9).
    """

    def __init__(self, kv):
        self.kv = kv
        self.root = _RadixNode()
        self._slot_node = {}   # slot -> registration node
        self._slot_len = {}    # slot -> retained prefix length
        self._slot_version = {}  # slot -> weights_version at registration
        self._lru = {}         # slot -> last-use tick (monotonic)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0  # whole-trie drops (weight swaps)
        self.tier = None

    def _touch(self, slot):
        self._tick += 1
        self._lru[slot] = self._tick

    @staticmethod
    def _common(edge, tokens, depth):
        n = min(len(edge), len(tokens) - depth)
        m = 0
        while m < n and edge[m] == tokens[depth + m]:
            m += 1
        return m

    def insert(self, slot, tokens):
        """Register ``slot`` as holding KV for the full ``tokens`` prefix.
        One registration per slot; rows stamped under older weights cannot
        register."""
        if slot in self._slot_node:
            raise ValueError(f"slot {slot} already registered in the prefix trie")
        if self.kv.slot_version[slot] != self.kv.weights_version:
            raise ValueError(f"slot {slot} holds KV stamped weights_version "
                             f"{int(self.kv.slot_version[slot])} but the pool is at "
                             f"{self.kv.weights_version}: stale-weights rows cannot register "
                             f"as reusable prefixes")
        tokens = tuple(int(t) for t in tokens)
        node, depth = self.root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                new = _RadixNode(edge=tokens[depth:], parent=node)
                node.children[tokens[depth]] = new
                node, depth = new, len(tokens)
                break
            m = self._common(child.edge, tokens, depth)
            if m < len(child.edge):
                # split the edge at the divergence/exhaustion point
                mid = _RadixNode(edge=child.edge[:m], parent=node)
                node.children[tokens[depth]] = mid
                child.edge = child.edge[m:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node, depth = mid, depth + m
            else:
                node, depth = child, depth + m
        node.slots.add(slot)
        self._slot_node[slot] = node
        self._slot_len[slot] = len(tokens)
        self._slot_version[slot] = self.kv.weights_version
        self.kv.refs[slot] += 1
        self._touch(slot)

    def match(self, tokens):
        """Longest registered prefix of ``tokens``: ``(matched_len,
        donor_slot)`` or ``(0, None)``. Any slot in the deepest matched
        node's subtree shares at least ``matched_len`` tokens with the
        prompt (most recently used wins)."""
        tokens = tuple(int(t) for t in tokens)
        node, depth = self.root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                break
            m = self._common(child.edge, tokens, depth)
            depth += m
            node = child
            if m < len(child.edge):
                break  # partial edge: child's subtree still shares `depth`
        if depth == 0:
            return 0, None
        donor = self._best_slot(node)
        if donor is None:
            return 0, None
        return min(depth, self._slot_len[donor]), donor

    def _best_slot(self, node):
        """Most-recently-used slot registered in ``node``'s subtree whose
        registration matches the pool's current weights version."""
        best, best_tick = None, -1
        stack = [node]
        while stack:
            n = stack.pop()
            for s in n.slots:
                if (self._slot_version.get(s) != self.kv.weights_version
                        or self.kv.slot_version[s] != self.kv.weights_version):
                    continue
                if self._lru.get(s, 0) > best_tick:
                    best, best_tick = s, self._lru.get(s, 0)
            stack.extend(n.children.values())
        return best

    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def touch(self, slot):
        """LRU bump on a prefix hit."""
        if slot in self._slot_node:
            self._touch(slot)

    def remove(self, slot):
        """Drop ``slot``'s registration (and its trie reference), pruning
        now-empty branches up to the root."""
        node = self._slot_node.pop(slot, None)
        if node is None:
            return False
        node.slots.discard(slot)
        del self._slot_len[slot]
        self._slot_version.pop(slot, None)
        self._lru.pop(slot, None)
        self.kv.refs[slot] -= 1
        while node is not self.root and not node.slots and not node.children:
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent
        return True

    def evict_lru(self, prefer_not=None):
        """Evict the least-recently-used CACHED registration and return its
        slot (the caller reclaims it), or None when nothing is evictable.
        ``prefer_not``: a slot to spare when any other candidate exists (the
        incoming prompt's matched donor)."""
        candidates = [s for s in self._slot_node if self.kv.state[s] == "cached"]
        if not candidates:
            return None
        spared = [s for s in candidates if s != prefer_not]
        victim = min(spared or candidates, key=lambda s: self._lru.get(s, 0))
        if self.tier is not None and len(self._slot_node[victim].slots) == 1:
            # hierarchical KV: the prefix rows demote to the host tier
            # BEFORE the registration goes (the key comes from the trie
            # path). Only the LAST device copy of a key demotes: a sibling
            # registration at the same node holds the identical key, and
            # demoting one copy would put the key in both tiers
            self.tier.demote(victim, self.registered_tokens(victim))
        self.remove(victim)
        self.evictions += 1
        return victim

    def registered_tokens(self, slot):
        """The full token sequence ``slot`` registered (the trie path's
        edges concatenated root to registration node), or () when
        unregistered: the demotion path keys host-tier entries on it, so
        the trie doubles as the token storage."""
        node = self._slot_node.get(slot)
        if node is None:
            return ()
        edges = []
        while node.parent is not None:
            edges.append(node.edge)
            node = node.parent
        out = tuple(t for edge in reversed(edges) for t in edge)
        assert len(out) == self._slot_len[slot], (slot, len(out))
        return out

    def invalidate_all(self):
        """Drop EVERY registration and reclaim every cached slot (the
        weight-swap path: KV computed under the outgoing weights must never
        be served against the new ones), and with a tier attached its host
        entries of the outgoing version too. Registrations of LIVE slots
        raise (flush in-flight work first). Returns the KV tokens
        invalidated."""
        live = [s for s in self._slot_node if self.kv.state[s] == "active"]
        if live:
            raise ValueError(f"invalidate_all with live registered slots {live}: flush in-flight "
                             f"requests before swapping weights")
        dropped = 0
        for slot in list(self._slot_node):
            dropped += int(self.kv.lengths[slot])
            self.remove(slot)
            if self.kv.state[slot] == "cached":
                self.kv.reclaim(slot)
        if self.tier is not None:
            dropped += self.tier.invalidate()
        self.invalidations += 1
        return dropped

    def registered_len(self, slot):
        """Token length of ``slot``'s registered prefix (0 if unregistered)."""
        return self._slot_len.get(slot, 0)

    def check_invariants(self):
        """Pool invariants (:meth:`SlotKVCache.check_invariants`) plus every
        registration's metadata and reachability from the root, and with a
        tier attached the one-tier-per-key contract: no prefix is
        device-registered here AND host-demoted by this same scheduler."""
        self.kv.check_invariants()
        for slot, node in self._slot_node.items():
            if slot not in self._slot_len or slot not in self._slot_version:
                raise AssertionError(f"slot {slot} registration missing metadata")
            if self.kv.refs[slot] != 1:
                raise AssertionError(f"slot {slot} registered with {self.kv.refs[slot]} refs")
            while node.parent is not None:
                node = node.parent
            if node is not self.root:
                raise AssertionError(f"slot {slot} registration not reachable from the root")
        if self.tier is not None:
            self.tier.check_invariants(self)

    def registered_slots(self):
        return sorted(self._slot_node)
