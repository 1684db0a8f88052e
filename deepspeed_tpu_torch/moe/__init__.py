"""``deepspeed_tpu_torch.moe``: top-k routed experts with expert parallelism
(``sharded_moe`` gating, ``layer`` modules)."""
from .layer import MoE, Experts, expert_ffn, expert_kernels, expert_parallel, shard_config, shard_params  # noqa: F401
from .sharded_moe import capacity, top_k_gating, top_k_serving_weights  # noqa: F401
