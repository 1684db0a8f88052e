"""The port's op-builder registry (``deepspeed_tpu_torch.ops.op_builder``) and
``env_report`` against the JAX package's: the same eight builder names and
classes, modules of the port, the CUDA sources each builds (only with a
card; each source named by the one module that launches it), the host C
library the offload ops build, the unported builders refusing with their
ROADMAP item, and the report's op table read from the registry, printed
without JAX."""

import importlib
import os
import re
import stat
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu.ops.op_builder as jax_ob
import deepspeed_tpu_torch.ops.op_builder as ob
from deepspeed_tpu_torch import env_report
from deepspeed_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNPORTED = ("random_ltd", )
PORTED = tuple(n for n in ob.ALL_OPS if n not in UNPORTED)


def test_builder_names_equal_jax():
    assert list(ob.ALL_OPS) == list(jax_ob.ALL_OPS)
    for name, b in ob.ALL_OPS.items():
        assert b.builder_name() == jax_ob.ALL_OPS[name].builder_name()
        assert b.absolute_name().startswith("deepspeed_tpu_torch.")


@pytest.mark.parametrize("name", PORTED)
def test_ported_builders_load_on_the_cpu(name, monkeypatch):
    """On the CPU ``load()`` imports the module and compiles nothing."""
    def no_build(names):
        raise AssertionError(f"built {names} without a card")
    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = ob.ALL_OPS[name]
    mod = b.load()
    assert mod.__name__ == b.MODULE and b.is_compatible()
    for src in b.sources():  # each named source is a kernel of the port
        assert os.path.exists(os.path.join(os.path.dirname(build.__file__), "csrc", src + ".cu"))


KERNEL_MODULES = ("flash_attention", "decode_attention", "quant_matmul", "decode_block",
                  "sparse_attention.block_sparse_attention", "qmm_microbench")


def test_every_cuda_source_has_one_owning_module():
    """Each ``ops/csrc/*.cu`` is named in the ``SOURCES`` of exactly one
    module, and the builders read the list from there, so it is kept in one
    place."""
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    owners = {}
    for name in KERNEL_MODULES:
        for src in importlib.import_module(f"deepspeed_tpu_torch.ops.{name}").SOURCES:
            owners.setdefault(src, []).append(name)
    assert all(len(v) == 1 for v in owners.values()), owners
    assert set(owners) == {f[:-3] for f in os.listdir(csrc) if f.endswith(".cu")}
    for b in ob.ALL_OPS.values():
        if b.ROADMAP is None:
            assert b.sources() == tuple(getattr(importlib.import_module(b.MODULE), "SOURCES", ()))


def test_sparse_attn_loads_the_sparse_module_and_builds_its_kernels_with_a_card(monkeypatch):
    built = []
    monkeypatch.setattr(build, "build_all", lambda names: built.append(list(names)) or {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mod = ob.SparseAttnBuilder().load()
    assert hasattr(mod, "SparseSelfAttention") and hasattr(mod, "make_block_sparse_attention")
    assert built == [["block_sparse_attention_fwd", "block_sparse_attention_bwd"]]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_builders_are_incompatible_with_a_roadmap_pointer(name):
    b = ob.ALL_OPS[name]
    assert not b.is_compatible()
    with pytest.raises(RuntimeError, match=r"not ported yet \(ROADMAP Queue 1 #\d+\)") as e:
        b.load()
    item = re.search(r"Queue 1 (#\d+)", str(e.value)).group(1)
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        assert f"**{item} " in f.read()


def test_default_compute_capabilities(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ob.get_default_compute_capabilities() == "9.0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i: (9, 0))
    assert ob.get_default_compute_capabilities() == "9.0"


def test_op_table_reflects_the_registry(monkeypatch):
    rows = env_report.op_compatibility()
    assert [r[0].split(" ")[0] for r in rows] == list(ob.ALL_OPS)
    assert [r[1] for r in rows] == [b.is_compatible() for b in ob.ALL_OPS.values()]
    sparse = dict((r[0].split(" ")[0], r) for r in rows)["sparse_attn"]
    assert sparse[0] == "sparse_attn [sparse_attention]" and "2 CUDA sources" in sparse[2]
    monkeypatch.setattr(ob.SparseAttnBuilder, "ROADMAP", "Queue 1 #11")
    rows = dict((r[0].split(" ")[0], r) for r in env_report.op_compatibility())
    assert rows["sparse_attn"][1] is False and "ROADMAP Queue 1 #11" in rows["sparse_attn"][2]


def test_env_report_finds_nvcc_through_the_build(tmp_path, monkeypatch):
    """The report names the nvcc ``ops/build.py`` builds with, or [NO]."""
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_nvcc", missing)
    assert env_report._nvcc() is None
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'Cuda compilation tools, release 12.4, V12.4.131'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    assert env_report._nvcc() == f"{nvcc} (release 12.4)"


def test_env_report_runs_without_jax():
    code = ("import sys\nfrom deepspeed_tpu_torch import env_report\nenv_report.main()\n"
            "print('JAX', sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deepspeed_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120).stdout
    assert out.strip().splitlines()[-1] == "JAX []", out
    for name in ob.ALL_OPS:
        assert re.search(rf"^{name}\b", out, re.M), name
    assert re.search(r"^torch\s+\S", out, re.M) and re.search(r"^numpy\s+\S", out, re.M)
    assert "nvcc" in out and "devices" in out
    module = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.env_report"], cwd=ROOT,
                            capture_output=True, text=True, check=True, timeout=120).stdout
    assert "sparse_attn [sparse_attention]" in module
