"""Host-side drafters for self-speculative decoding.

The port's own copy of ``deepspeed_tpu/inference/speculative.py`` (numpy
only): the same drafter, so the port's drafts equal the JAX package's.

Speculative decoding (Leviathan et al., "Fast Inference from Transformers
via Speculative Decoding") multiplies tokens per decode step: a cheap
drafter proposes ``k`` continuation tokens, ONE forward pass verifies all of
them (the chunked-prefill span machinery already evaluates multiple query
columns per slot per step), and the accepted prefix commits. This module
holds the draft side; the verify side lives in
:meth:`deepspeed_tpu_torch.inference.scheduler.DecodeScheduler._spec_decode_step`.

The shipped drafter is PROMPT LOOKUP (Saxena's prompt-lookup decoding /
n-gram self-drafting): no draft model at all — the context itself is the
draft distribution. The longest suffix n-gram of ``prompt + generated`` is
matched against its own earlier occurrences and the tokens that followed
the most recent match become the proposal. Free to compute (pure host-side
numpy over a few hundred tokens), and exactly the workloads the serving
path cares about — chat templates, agent loops, retrieval-stuffed prompts,
code edits — are the ones where the continuation quotes the context.

Acceptance stays LOSSLESS regardless of drafter quality: the scheduler
samples every verified column with the request's own keys at the column's
absolute step index and accepts a draft token only when it EQUALS the
sampled token, so the emitted stream is bit-identical to non-speculative
decode (greedy and sampled alike) — a bad drafter costs wasted verify
columns, never wrong tokens.
"""

import numpy as np


class PromptLookupDrafter:
    """n-gram prompt-lookup drafter.

    ``max_tokens``: proposal cap per call (the scheduler's spec width - 1).
    ``ngram_max``/``ngram_min``: suffix n-gram sizes tried longest-first;
    longer matches are rarer but their continuations are likelier to be
    accepted. Matching prefers the MOST RECENT prior occurrence with a
    FULL-WIDTH continuation (recency tracks the local pattern — loops,
    repeated template sections — but a match butting against the context's
    end can only propose its few trailing followers, which on a repeating
    tail would cap every draft at one token; when no match has
    ``max_tokens`` followers, the one with the most wins).
    """

    _MAX_CANDIDATES = 128  # most recent first-token occurrences scanned per level

    def __init__(self, max_tokens, ngram_max=3, ngram_min=1):
        self.max_tokens = int(max_tokens)
        self.ngram_max = max(1, int(ngram_max))
        self.ngram_min = max(1, min(int(ngram_min), self.ngram_max))

    def draft(self, context, max_tokens=None):
        """Propose up to ``max_tokens`` continuation tokens for ``context``
        (1-D int array, prompt + generated so far). Returns an int32 array,
        possibly empty (no suffix n-gram recurs earlier in the context)."""
        cap = self.max_tokens if max_tokens is None else min(int(max_tokens),
                                                            self.max_tokens)
        ctx = np.asarray(context, np.int32).reshape(-1)
        L = ctx.size
        if cap <= 0 or L < 2:
            return np.empty(0, np.int32)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            pattern = ctx[L - n:]
            # candidate starts leave >= 1 token after the match and exclude
            # the suffix itself (start <= L - n - 1); cap candidates at the
            # most recent _MAX_CANDIDATES — this runs per live slot per
            # decode sync, and a frequent first token (punctuation, template
            # delimiters) in a multi-k context must not turn the draft into
            # milliseconds of host work racing the device step
            starts = np.flatnonzero(ctx[:L - n] == pattern[0])
            if starts.size > self._MAX_CANDIDATES:
                starts = starts[-self._MAX_CANDIDATES:]
            if starts.size == 0:
                continue
            # vectorized full-pattern compare over every candidate at once
            hits = starts[(ctx[starts[:, None] + np.arange(n)[None, :]]
                           == pattern[None, :]).all(axis=1)]
            if hits.size == 0:
                continue
            follow_ns = np.minimum(L - (hits + n), cap)
            full = hits[follow_ns >= cap]
            if full.size:
                s = int(full[-1])  # most recent full-width match
                return ctx[s + n:s + n + cap].astype(np.int32, copy=True)
            s = int(hits[np.argmax(follow_ns)])
            follow_n = int(min(L - (s + n), cap))
            if follow_n > 0:
                return ctx[s + n:s + n + follow_n].astype(np.int32, copy=True)
        return np.empty(0, np.int32)
