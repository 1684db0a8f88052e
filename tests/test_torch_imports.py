"""The port stands alone: no module of ``deepspeed_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax or the JAX package — checked on the
source (every import statement, at any depth) and by importing the package
in a fresh interpreter."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeed_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "deepspeed_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["deepspeed_tpu_torch", "deepspeed_tpu_torch.inference.engine",
            "deepspeed_tpu_torch.inference.scheduler", "deepspeed_tpu_torch.inference.kv_cache",
            "deepspeed_tpu_torch.ops.quantizer", "deepspeed_tpu_torch.ops.decode_attention",
            "deepspeed_tpu_torch.runtime.engine", "deepspeed_tpu_torch.models.convert",
            "deepspeed_tpu_torch.ops.build", "deepspeed_tpu_torch.ops.sparse_attention",
            "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention",
            "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention",
            "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
            "deepspeed_tpu_torch.ops.op_builder", "deepspeed_tpu_torch.env_report",
            "deepspeed_tpu_torch.ops.qmm_microbench", "deepspeed_tpu_torch.benchmarks.qmm_microbench",
            "deepspeed_tpu_torch.benchmarks.sparse_sweep", "deepspeed_tpu_torch.inference.speculative",
            "deepspeed_tpu_torch.telemetry", "deepspeed_tpu_torch.telemetry.sink",
            "deepspeed_tpu_torch.telemetry.capacity", "deepspeed_tpu_torch.telemetry.profiler",
            "deepspeed_tpu_torch.telemetry.slo", "deepspeed_tpu_torch.telemetry.tracing",
            "deepspeed_tpu_torch.telemetry.prometheus", "deepspeed_tpu_torch.telemetry.flight_recorder",
            "deepspeed_tpu_torch.monitor.monitor", "deepspeed_tpu_torch.serving",
            "deepspeed_tpu_torch.serving.gateway", "deepspeed_tpu_torch.serving.replica",
            "deepspeed_tpu_torch.serving.fair_queue", "deepspeed_tpu_torch.serving.capacity_math",
            "deepspeed_tpu_torch.serving.__main__", "deepspeed_tpu_torch.serving.router",
            "deepspeed_tpu_torch.utils.counter_hash",
            "deepspeed_tpu_torch.runtime.optimizers", "deepspeed_tpu_torch.runtime.checkpoint_engine.engine",
            "deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing",
            "deepspeed_tpu_torch.checkpoint", "deepspeed_tpu_torch.checkpoint.zero_checkpoint",
            "deepspeed_tpu_torch.ops.adam", "deepspeed_tpu_torch.ops.adam.cpu_adam", "deepspeed_tpu_torch.ops.aio",
            "deepspeed_tpu_torch.memory", "deepspeed_tpu_torch.memory.streams",
            "deepspeed_tpu_torch.memory.prefix_store", "deepspeed_tpu_torch.memory.kv_tier",
            "deepspeed_tpu_torch.memory.net_store",
            "deepspeed_tpu_torch.runtime.swap_tensor", "deepspeed_tpu_torch.runtime.swap_tensor.aio_config",
            "deepspeed_tpu_torch.runtime.swap_tensor.read_window",
            "deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper",
            "deepspeed_tpu_torch.runtime.zero.offload", "deepspeed_tpu_torch.runtime.zero.param_offload"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
