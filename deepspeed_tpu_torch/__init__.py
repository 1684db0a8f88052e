"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The port runs on an NVIDIA H100: plain tensor code is PyTorch and every
TPU kernel on a ported path is a CUDA kernel written for Hopper
(``ops/csrc``). It mirrors the JAX package's layout file for file and never
imports JAX or ``deepspeed_tpu``. It serves static-batch ``generate()``
(int8 kernel-injected: the fused decode layer by default, or the
per-projection kernels), serves continuous batching through
``engine.scheduler()`` / ``engine.submit()`` (chunked prefill, radix prefix
cache, int8 KV, on the paged decode and span kernels) and trains through ``initialize()``
→ ``train_batch()`` (fp32 master weights, bf16 compute, AdamW, flash
attention's forward and backward kernels; data-parallel over a
``torch.distributed`` world, ``comm``, at ZeRO stages 0-3 with the
sharding planner of ``runtime/zero/sharding.py``, and with the ZeRO-Offload
and ZeRO-Infinity tiers on one rank or many), serves and trains MoE models
(``moe``: Mixtral, with expert parallelism), and runs block-sparse attention
(``ops.sparse_attention``: every ``SparsityConfig``, forward and backward
on three table-driven kernels); see ``ROADMAP.md`` for what is still to
come.
"""

import os

from .accelerator import get_accelerator  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.engine import DeepSpeedEngine  # noqa: F401
from .runtime.lr_schedules import (WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest)  # noqa: F401
from .utils.logging import logger, log_dist  # noqa: F401


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               device=None):
    """Initialize the training engine (reference ``deepspeed.initialize``).

    Returns the reference 4-tuple ``(engine, optimizer, dataloader,
    lr_scheduler)``: the optimizer slot carries the engine itself (the
    update runs inside ``train_batch``/``step``), the dataloader slot None
    (``deepspeed_io`` is not ported yet) and the lr_scheduler slot the
    stateful schedule. ``model``: a ``deepspeed_tpu_torch.models`` model or
    a ``loss_fn(params, batch)``; ``model_parameters``: an optional state
    dict (``models/convert.py`` carries a JAX tree across), else the
    model's ``init_params(config seed)``. ``device``: ``None`` means the
    CUDA card, and raises when there is none; pass ``"cpu"`` to run the
    kernels' plain versions on the host."""
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config to specify configuration file")
    engine = DeepSpeedEngine(model=model,
                             config=config,
                             optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn,
                             device=device)
    return engine, engine, engine.training_dataloader, engine.lr_scheduler


def _is_hf_source(model):
    """A HuggingFace checkpoint directory or ``transformers`` model."""
    if isinstance(model, str):
        return os.path.isdir(model)
    return hasattr(model, "config") and hasattr(model, "state_dict") and not hasattr(model, "cfg")


def init_inference(model=None, config=None, params=None, device=None, **kwargs):
    """Initialize the inference engine (reference ``deepspeed.init_inference``).

    ``model``: a ``deepspeed_tpu_torch.models`` model or preset name.
    ``params``: optional state dict (``models/convert.py`` carries a JAX tree
    across); random weights from seed 0 otherwise. ``device``: ``None`` means
    the CUDA card, and raises when there is none; pass ``"cpu"`` to run the
    kernels' plain versions on the host."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine
    if _is_hf_source(model):
        raise NotImplementedError("deepspeed_tpu_torch does not serve HuggingFace sources yet "
                                  "(ROADMAP Queue 1 #10, module_inject)")
    if isinstance(config, DeepSpeedInferenceConfig):
        ds_inference_config = config
    else:
        config_dict = dict(config or {})
        config_dict.update(kwargs)
        ds_inference_config = DeepSpeedInferenceConfig(config_dict)
    return InferenceEngine(model, config=ds_inference_config, params=params, device=device)
