from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,  # noqa: F401
                              VariableSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig, LocalSlidingWindowSparsityConfig)
from .block_sparse_attention import SOURCES, make_block_sparse_attention  # noqa: F401
from .sparse_self_attention import SparseSelfAttention  # noqa: F401
