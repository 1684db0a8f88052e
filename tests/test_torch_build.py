"""``ops/build.py`` without a CUDA toolkit: a stand-in ``nvcc`` (a Python
script that writes its ``-o`` file and logs each call) takes the real one's
place, so the bookkeeping around the compiler is checked on the CPU."""

import os
import stat
import sys

import pytest

from deepspeed_tpu_torch.ops import build

FAKE_NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(args[-1] + "\\n")
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: stand-in failure")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
print("ptxas info    : Used 32 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    out = tmp_path / "_build"
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    return calls, out


def _called(calls):
    return [os.path.basename(p) for p in calls.read_text().split()] if calls.exists() else []


def test_a_source_named_twice_builds_once(fake_nvcc):
    # dq and dk/dv share flash_attention_bwd.cu: two nvcc processes writing
    # one temporary file could race, so the name must build once
    calls, out = fake_nvcc
    logs = build.build_all(["flash_attention_bwd", "quant_matmul", "flash_attention_bwd"])
    assert sorted(logs) == ["flash_attention_bwd", "quant_matmul"]
    assert sorted(_called(calls)) == ["flash_attention_bwd.cu", "quant_matmul.cu"]
    assert sorted(p.suffix for p in out.iterdir()) == [".log", ".log", ".so", ".so"]
    assert "registers" in logs["quant_matmul"]


def test_a_built_library_is_reused(fake_nvcc):
    calls, _ = fake_nvcc
    build.build_all(["decode_attention"])
    build.build_all(["decode_attention", "decode_attention"])
    assert _called(calls) == ["decode_attention.cu"]


def test_a_failed_build_raises_and_leaves_no_library(fake_nvcc, monkeypatch):
    _, out = fake_nvcc
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed to build fused_qkv_ln.cu"):
        build.build_all(["fused_qkv_ln"])
    assert not [p for p in out.iterdir() if p.suffix == ".so"]
