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
            "deepspeed_tpu_torch.models.convert", "deepspeed_tpu_torch.ops.build"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
