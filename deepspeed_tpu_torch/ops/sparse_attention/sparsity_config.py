"""Block-sparse attention layout configurations.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (numpy only): the same class names, constructor
parameters and layouts, bit for bit, including the seeded random draws of
Variable and BigBird. Each config produces a layout array of shape
``(num_heads, num_blocks, num_blocks)`` with 1 where a (query-block,
key-block) tile participates in attention; the CUDA kernels of
``block_sparse_attention.py`` walk it through per-row and per-column index
tables.

The patterns are the published ones the reference implements:
- Fixed (Sparse Transformers, Child et al. 2019): local windows + global
  summary blocks.
- BigBird (Zaheer et al. 2020): sliding window + random + global.
- BSLongformer (Beltagy et al. 2020): sliding window + designated global
  indices.
- Variable: per-window local sizes + random + global, generalizing Fixed.
- LocalSlidingWindow: sliding window only.
"""

import numpy as np


class SparsityConfig:
    """Base: block size, head count, per-head layout sharing."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"sequence length {seq_len} must be a multiple of block "
                             f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def propagate_first_head(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    # subclasses implement make_layout(seq_len)
    def make_layout(self, seq_len):
        raise NotImplementedError

    def _apply_attention_direction(self, layout, attention):
        if attention == "unidirectional":
            # zero strictly-upper-triangular blocks; the in-block diagonal
            # masking happens inside the kernel
            nb = layout.shape[1]
            layout *= np.tril(np.ones((nb, nb), dtype=layout.dtype))[None]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active (debug/reference point)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[...] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks``; the last ``num_global_blocks``
    of each window act as global tokens (column-global, plus row-global when
    ``horizontal_global_attention``). Different heads may use different
    representative blocks (``num_different_global_patterns``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(f"num_local_blocks {num_local_blocks} must be divisible by "
                             f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal_global_attention requires bidirectional attention")
        max_patterns = num_local_blocks // num_global_blocks
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires "
                             "different_layout_per_head")
        if num_different_global_patterns > max_patterns:
            raise ValueError(f"num_different_global_patterns {num_different_global_patterns} "
                             f"exceeds {max_patterns}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local windows (block-diagonal bands of window size)
            for w0 in range(0, nb, self.num_local_blocks):
                w1 = min(w0 + self.num_local_blocks, nb)
                layout[h, w0:w1, w0:w1] = 1
            # global representatives: last num_global_blocks of each window,
            # rotated per head when multiple patterns are requested
            rot = (h % self.num_different_global_patterns) * self.num_global_blocks
            for w0 in range(0, nb, self.num_local_blocks):
                g0 = w0 + self.num_local_blocks - self.num_global_blocks - rot
                if g0 < w0 or g0 >= nb:
                    continue
                g1 = min(g0 + self.num_global_blocks, nb)
                first_row = 0 if self.attention == "bidirectional" else g0
                layout[h, first_row:, g0:g1] = 1  # everyone attends the reps
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1  # reps attend everyone
        layout = self.propagate_first_head(layout)
        return self._apply_attention_direction(layout, self.attention)


class VariableSparsityConfig(SparsityConfig):
    """Generalized Fixed: random blocks, a list of local window sizes (last
    entry repeats), and explicit global block indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=[4], global_block_indices=[0],
                 global_block_end_indices=None, attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal_global_attention requires bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != len(global_block_indices):
                raise ValueError("global_block_end_indices must pair with global_block_indices")
            self.global_block_end_indices = list(global_block_end_indices)
        else:
            self.global_block_end_indices = None
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _global_ranges(self, nb):
        if self.global_block_end_indices is None:
            return [(i, i + 1) for i in self.global_block_indices if i < nb]
        return [(s, min(e, nb)) for s, e in zip(self.global_block_indices,
                                                self.global_block_end_indices) if s < nb]

    def make_layout(self, seq_len):
        rng = np.random.default_rng(0)  # deterministic: layouts are compile-time
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_layout_heads):
            if self.num_random_blocks:
                for row in range(nb):
                    cols = rng.choice(nb, size=min(self.num_random_blocks, nb), replace=False)
                    layout[h, row, cols] = 1
            w0 = 0
            wi = 0
            while w0 < nb:
                size = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                w1 = min(w0 + size, nb)
                layout[h, w0:w1, w0:w1] = 1
                w0 = w1
                wi += 1
            for g0, g1 in self._global_ranges(nb):
                first_row = 0 if self.attention == "bidirectional" else g0
                layout[h, first_row:, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
        layout = self.propagate_first_head(layout)
        return self._apply_attention_direction(layout, self.attention)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global (first/last blocks)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention {attention!r}")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        rng = np.random.default_rng(0)
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        g = min(self.num_global_blocks, nb)
        for h in range(self.num_layout_heads):
            for row in range(nb):
                lo, hi = max(0, row - w), min(nb, row + w + 1)
                layout[h, row, lo:hi] = 1  # sliding window
                if self.attention == "bidirectional":
                    choices = np.arange(nb)
                else:
                    choices = np.arange(row + 1)
                k = min(self.num_random_blocks, len(choices))
                layout[h, row, rng.choice(choices, size=k, replace=False)] = 1
            layout[h, :, :g] = 1  # global columns (first blocks)
            layout[h, :g, :] = 1  # global rows
            if self.attention == "bidirectional":
                layout[h, :, nb - g:] = 1  # and last blocks
                layout[h, nb - g:, :] = 1
        layout = self.propagate_first_head(layout)
        return self._apply_attention_direction(layout, self.attention)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + designated global indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=[0],
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != len(global_block_indices):
                raise ValueError("global_block_end_indices must pair with global_block_indices")
        self.global_block_end_indices = (list(global_block_end_indices)
                                         if global_block_end_indices is not None else None)
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices if i < nb]
        else:
            ranges = [(s, min(e, nb)) for s, e in zip(self.global_block_indices,
                                                      self.global_block_end_indices) if s < nb]
        for h in range(self.num_layout_heads):
            for row in range(nb):
                lo, hi = max(0, row - w), min(nb, row + w + 1)
                layout[h, row, lo:hi] = 1
            for g0, g1 in ranges:
                layout[h, :, g0:g1] = 1
                layout[h, g0:g1, :] = 1
        layout = self.propagate_first_head(layout)
        return self._apply_attention_direction(layout, self.attention)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Sliding window only (cheap long-context autoregression)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for row in range(nb):
            if self.attention == "unidirectional":
                lo, hi = max(0, row - (self.num_sliding_window_blocks - 1)), row + 1
            else:
                lo, hi = max(0, row - w), min(nb, row + w + 1)
            layout[0, row, lo:hi] = 1
        layout = self.propagate_first_head(layout)
        return self._apply_attention_direction(layout, self.attention)
