"""The port's scaffolding against the JAX package's: the inference config
has the same keys (at every depth) and dtype map, the preset registry the
same models and shapes, and the accelerator picks the host when no card is
present and gives the H100's datasheet peaks for the card."""

import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu.models as jm
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.inference import config as jcfg
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator
from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator
from deepspeed_tpu_torch.inference import config as tcfg


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_inference_config_has_the_jax_keys():
    mine = tcfg.DeepSpeedInferenceConfig({}).to_dict()
    ref = jcfg.DeepSpeedInferenceConfig({}).to_dict()
    assert _keys(mine) == _keys(ref)


@pytest.mark.parametrize("name", sorted(jcfg._DTYPE_MAP))
def test_inference_dtype_map_matches_jax(name):
    mine = tcfg.DeepSpeedInferenceConfig({"dtype": name}).dtype
    ref = jcfg.DeepSpeedInferenceConfig({"dtype": name}).dtype
    assert str(mine).replace("torch.", "") == jnp.dtype(ref).name


def test_inference_config_aliases_and_unknown_keys():
    cfg = tcfg.DeepSpeedInferenceConfig({"replace_with_kernel_inject": True, "max_tokens": 96,
                                         "mp_size": 1})
    assert cfg.kernel_inject and cfg.max_out_tokens == 96 and cfg.tensor_parallel.tp_size == 1
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcfg.DeepSpeedInferenceConfig({"no_such_key": 1})
    with pytest.raises(ValueError, match="Invalid inference dtype"):
        tcfg.DeepSpeedInferenceConfig({"dtype": "int4"})


@pytest.mark.parametrize("section", [{"continuous_batching": {"multi_lora": {"enabled": True}}},
                                     {"continuous_batching": {"autoscaler": {"enabled": True}}},
                                     {"continuous_batching": {"expert_offload": {"enabled": True}}},
                                     {"checkpoint": "ckpt"}])
def test_unported_sections_raise_when_enabled(section):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tcfg.DeepSpeedInferenceConfig(section)


@pytest.mark.parametrize("section", [{"gateway": {"port": 1, "max_queue_depth": 3}},
                                     {"telemetry": {"enabled": True, "output_path": "tel"}}])
def test_gateway_and_telemetry_sections_build(section):
    """The serving gateway and telemetry sections build (ROADMAP Queue 1 #6
    is ported)."""
    cfg = tcfg.DeepSpeedInferenceConfig(section)
    if "gateway" in section:
        assert cfg.gateway.port == 1 and cfg.gateway.max_queue_depth == 3
    else:
        assert cfg.telemetry["enabled"] and cfg.telemetry["output_path"] == "tel"


@pytest.mark.parametrize("name", jm.available_models())
def test_presets_match_jax(name):
    assert tm.available_models() == jm.available_models()
    mine, ref = tm._PRESETS[name](), jm._PRESETS[name]()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "kv_heads", "head_size",
              "ffn_size", "max_seq_len", "pos_embedding", "norm", "activation", "tie_embeddings",
              "rope_theta", "num_experts"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.num_params() == ref.num_params()


def test_accelerator_is_the_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    acc = get_accelerator()
    assert acc.device() == torch.device("cpu") and acc.communication_backend_name() == "gloo"


def test_cuda_accelerator_peaks_are_the_h100_datasheet():
    acc = CUDA_Accelerator()  # the peaks need no card
    assert acc.peak_flops(torch.bfloat16) == 989e12
    assert acc.peak_flops(torch.int8) == 1979e12
    assert acc.peak_hbm_bandwidth() == 3.35e12
