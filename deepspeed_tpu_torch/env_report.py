"""Environment report — the ``ds_report`` equivalent (reference
``deepspeed/env_report.py``: op-compatibility matrix + framework versions).

Port of ``deepspeed_tpu/env_report.py``. Run as
``python -m deepspeed_tpu_torch.env_report``. Reports the framework
versions (torch, its CUDA, numpy, the ``nvcc`` the kernels build with), the
visible cards, and the op table of the op-builder registry
(``ops/op_builder``). Nothing is compiled: an op's CUDA sources, or the
host C source of an offload op (``cpu_adam``, ``aio``), are reported as
built (a library for the current source is in ``ops/_build/``) or as
building at first use."""

import importlib
import os
import subprocess
import sys

GREEN_OK = "[OKAY]"
RED_NO = "[NO]"


def _version(mod_name):
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, "__version__", "unknown")
    except Exception:
        return None


def _nvcc():
    """'<path> (release X.Y)' of the nvcc the kernels build with, or None."""
    from .ops import build
    try:
        path = build._nvcc()
    except RuntimeError:
        return None
    try:
        out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60).stdout
    except Exception as e:
        return f"{path} ({e})"
    release = next((ln.split("release", 1)[1].split(",")[0].strip() for ln in out.splitlines()
                    if "release" in ln), "unknown")
    return f"{path} (release {release})"


def op_compatibility():
    """(name, compatible, status_detail) per registered op — driven by the
    op-builder registry (``ops/op_builder``), the analogue of the reference's
    ``op_builder`` ``is_compatible`` table."""
    from .ops import build
    from .ops.op_builder import ALL_OPS
    rows = []
    for name, builder in ALL_OPS.items():
        try:
            builder._import()
        except Exception as e:
            rows.append((name, False, str(e)[:60]))
            continue
        label = f"{name} [{builder.MODULE.rsplit('.', 1)[-1]}]"
        sources = builder.sources()
        mod = importlib.import_module(builder.MODULE)
        if hasattr(mod, "SOURCE"):  # a host C library
            built = os.path.exists(build._host_paths(mod.SOURCE, mod.FLAGS)[1])
            detail = f"host C {mod.SOURCE}.c " + ("built" if built else "(cc) at first use")
        elif not sources:
            detail = "importable"
        else:
            built = sum(os.path.exists(build._paths(s)[1]) for s in sources)
            detail = (f"{built}/{len(sources)} CUDA sources built" if built else
                      f"{len(sources)} CUDA sources, nvcc sm_90a at first use")
        rows.append((label, True, detail))
    return rows


def devices_summary():
    try:
        import torch
        if not torch.cuda.is_available():
            return "cpu: no CUDA card"
        kinds = {}
        for i in range(torch.cuda.device_count()):
            kinds[torch.cuda.get_device_name(i)] = kinds.get(torch.cuda.get_device_name(i), 0) + 1
        return "cuda: " + ", ".join(f"{n}x {k}" for k, n in kinds.items())
    except Exception as e:
        return f"unavailable ({e})"


def main(hide_operator_status=False, hide_errors_and_warnings=False):
    lines = ["-" * 64, "DeepSpeed-TPU (PyTorch/CUDA port) environment report", "-" * 64]
    lines.append(f"python ................ {sys.version.split()[0]}")
    for mod in ("torch", "numpy"):
        v = _version(mod)
        lines.append(f"{mod:<22} {v if v else RED_NO}")
    try:
        import torch
        cuda = torch.version.cuda
    except Exception:
        cuda = None
    lines.append(f"{'torch CUDA':<22} {cuda if cuda else RED_NO}")
    nvcc = _nvcc()
    lines.append(f"{'nvcc':<22} {nvcc if nvcc else RED_NO}")
    lines.append(f"devices ............... {devices_summary()}")
    try:
        from .accelerator import get_accelerator
        acc = get_accelerator()
        lines.append(f"accelerator ........... {acc.device_name()} "
                     f"(peak {acc.peak_flops() / 1e12:.0f} TFLOP/s bf16)")
    except Exception:
        pass

    if not hide_operator_status:
        lines.append("")
        lines.append(f"{'op name':<44}{'compatible':<12}status")
        for name, ok, detail in op_compatibility():
            lines.append(f"{name:<44}{GREEN_OK if ok else RED_NO:<12}{detail}")
    report = "\n".join(lines)
    print(report)
    return report


def cli_main():
    main()


if __name__ == "__main__":
    main()
