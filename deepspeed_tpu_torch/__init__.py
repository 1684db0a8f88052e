"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The port runs on an NVIDIA H100: plain tensor code is PyTorch and every
TPU kernel on a ported path is a CUDA kernel written for Hopper
(``ops/csrc``). It mirrors the JAX package's layout file for file and never
imports JAX or ``deepspeed_tpu``. This slice serves static-batch
``generate()`` (int8 kernel-injected, per-projection kernels); see
``ROADMAP.md`` for what is still to come.
"""

import os

from .accelerator import get_accelerator  # noqa: F401
from .utils.logging import logger, log_dist  # noqa: F401


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
