"""SparseSelfAttention: layout-driven attention over (B, H, T, D) tensors.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(reference ``ops/sparse_attention/sparse_self_attention.py:19``, whose
forward composes Triton sdd-matmul -> sparse softmax -> dsd-matmul): here
one forward and two backward CUDA kernels walk the layout's index tables.
The layout, its tables and its attention function are built lazily per
sequence length and cached; the tables live on the query's device.
"""

from torch import nn

from ...utils.logging import logger
from .block_sparse_attention import make_block_sparse_attention


class SparseSelfAttention(nn.Module):
    """No parameters: q, k and v come from the caller's projections."""

    def __init__(self, sparsity_config, scale=None, max_seq_length=None):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.scale = scale
        self.max_seq_length = max_seq_length
        self._cache = {}  # seq_len -> attend fn

    def _attend_fn(self, seq_len):
        fn = self._cache.get(seq_len)
        if fn is None:
            cfg = self.sparsity_config
            layout = cfg.make_layout(seq_len)
            causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
            density = float(layout.mean())
            logger.info(f"SparseSelfAttention: {type(cfg).__name__} layout for seq {seq_len}: "
                        f"{layout.shape[1]}x{layout.shape[2]} blocks of {cfg.block}, "
                        f"density {density:.1%}{' (causal)' if causal else ''}")
            fn = make_block_sparse_attention(layout, cfg.block, causal=causal, scale=self.scale)
            self._cache[seq_len] = fn
        return fn

    def forward(self, query, key, value):
        """query/key/value: (B, H, T, D) with H == sparsity_config.num_heads
        and T a multiple of the config block size. Returns (B, H, T, D)."""
        if self.max_seq_length is not None and query.shape[2] > self.max_seq_length:
            raise ValueError(f"sequence {query.shape[2]} exceeds max_seq_length "
                             f"{self.max_seq_length}")
        return self._attend_fn(query.shape[2])(query, key, value)
