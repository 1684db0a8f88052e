"""Model presets: the same registry as ``deepspeed_tpu/models/__init__.py``."""

import dataclasses

from .transformer import TransformerConfig, CausalLM, CausalLMModel  # noqa: F401

_PRESETS = {}


def register(name):

    def deco(fn):
        _PRESETS[name] = fn
        return fn

    return deco


def available_models():
    return sorted(_PRESETS)


def get_model(name, **overrides):
    if name not in _PRESETS:
        raise ValueError(f"Unknown model {name}; available: {available_models()}")
    cfg = _PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return CausalLMModel(cfg)


def _gpt2(hidden, layers, heads, vocab=50257, seq=1024):
    return TransformerConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers, num_heads=heads,
                             max_seq_len=seq, pos_embedding="learned", norm="layernorm",
                             activation="gelu", tie_embeddings=True)


def _llama(hidden, layers, heads, kv_heads, ffn, vocab=128256, seq=8192, theta=500000.0):
    return TransformerConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers, num_heads=heads,
                             num_kv_heads=kv_heads, intermediate_size=ffn, max_seq_len=seq,
                             pos_embedding="rope", norm="rmsnorm", activation="swiglu",
                             tie_embeddings=False, rope_theta=theta)


def _opt(hidden, layers, heads, vocab=50272, seq=2048):
    return TransformerConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers, num_heads=heads,
                             max_seq_len=seq, pos_embedding="learned", norm="layernorm",
                             activation="relu", tie_embeddings=True)


@register("gpt2-125m")
def gpt2_125m():
    return _gpt2(768, 12, 12)


@register("gpt2-medium")
def gpt2_medium():
    return _gpt2(1024, 24, 16)


@register("gpt2-large")
def gpt2_large():
    return _gpt2(1280, 36, 20)


@register("gpt2-xl")
def gpt2_xl():
    return _gpt2(1600, 48, 25)


@register("llama3-8b")
def llama3_8b():
    return _llama(4096, 32, 32, 8, 14336)


@register("llama3-70b")
def llama3_70b():
    return _llama(8192, 80, 64, 8, 28672)


@register("llama2-7b")
def llama2_7b():
    return _llama(4096, 32, 32, 32, 11008, vocab=32000, seq=4096, theta=10000.0)


@register("mixtral-8x7b")
def mixtral_8x7b():
    cfg = _llama(4096, 32, 32, 8, 14336, vocab=32000, seq=4096, theta=1000000.0)
    return dataclasses.replace(cfg, num_experts=8, moe_top_k=2)


@register("opt-125m")
def opt_125m():
    return _opt(768, 12, 12)


@register("opt-66b")
def opt_66b():
    return _opt(9216, 64, 72)


@register("tiny")
def tiny():
    """Test-scale llama-style model."""
    return TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                             num_kv_heads=2, max_seq_len=128, intermediate_size=128)


@register("tiny-gpt2")
def tiny_gpt2():
    """Test-scale gpt2-style model (learned positions, layernorm, gelu, MHA)."""
    return TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                             max_seq_len=128, intermediate_size=128,
                             pos_embedding="learned", norm="layernorm",
                             activation="gelu", tie_embeddings=True)


@register("tiny-moe")
def tiny_moe():
    return TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                             num_kv_heads=2, max_seq_len=128, intermediate_size=128,
                             num_experts=4, moe_top_k=2)
