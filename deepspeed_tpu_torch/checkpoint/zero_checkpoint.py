"""Reference-checkpoint import: DeepSpeed ZeRO training checkpoints -> fp32
state dicts.

Port of ``deepspeed_tpu/checkpoint/zero_checkpoint.py`` (counterpart of
reference ``deepspeed/utils/zero_to_fp32.py`` and
``deepspeed/checkpoint/universal_checkpoint.py``): consolidate the
per-DP-rank fp32 optimizer fragments of a ZeRO-1/2/3 checkpoint back into
full fp32 weights, or read a universal-checkpoint folder. Both return
``{name: fp32 torch.Tensor}`` in the trained module's names and read every
file with ``torch.load(..., weights_only=True)``.

Format notes (verified against the reference reader):
- files per tag dir: ``*_model_states.pt`` (module sd, ``param_shapes``,
  ``buffer_names``, frozen shapes/fragments, ``shared_params``) and one
  ``*_optim_states.pt`` per DP rank whose ``optimizer_state_dict`` carries
  ``zero_stage``, ``partition_count`` and the flat fp32 groups
  (``single_partition_of_fp32_groups`` at stage<=2, ``fp32_flat_groups``
  at stage 3).
- stage<=2: each group's rank partitions concatenate into one flat vector;
  params slice out in declaration order (tail padding aligned to
  ``2 * world_size``).
- stage 3: every param is individually partitioned; rank fragments of
  ``ceil(numel/ws)`` zip back together per param.

The Megatron and HF-policy functions need the injection policies, not
ported yet: they raise ``NotImplementedError`` naming ROADMAP Queue 1 #10.
"""

import glob
import math
import os
import re

import torch

from ..utils.logging import logger

_MODULE_INJECT = "ROADMAP Queue 1 #10, module_inject"


def _fp32(t):
    return t.detach().to("cpu", torch.float32)


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _natural(files):
    return sorted(files, key=lambda f: [int(x) if x.isdigit() else x for x in re.split(r"(\d+)", f)])


def _resolve_tag_dir(checkpoint_dir, tag):
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
    d = os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no checkpoint tag dir at {d}")
    return d


def _shape_tuple(shape):
    return tuple(int(s) for s in shape)


def _shape_numel(shape):
    return math.prod(_shape_tuple(shape))


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """Consolidated {param name: fp32 tensor} from a reference ZeRO
    checkpoint dir (the ``zero_to_fp32.py`` entry point)."""
    d = _resolve_tag_dir(checkpoint_dir, tag)
    model_files = _natural(glob.glob(os.path.join(d, "*_model_states.pt")))
    optim_files = _natural(glob.glob(os.path.join(d, "*_optim_states.pt")))
    if not model_files or not optim_files:
        raise FileNotFoundError(f"{d}: no *_model_states.pt / *_optim_states.pt files "
                                f"(not a reference ZeRO checkpoint)")

    model_states = [_torch_load(f) for f in model_files]
    optim_states = [_torch_load(f)["optimizer_state_dict"] for f in optim_files]
    if "zero_stage" not in optim_states[0]:
        raise ValueError(f"{optim_files[0]}: no zero_stage key — not a ZeRO optim checkpoint")
    stage = int(optim_states[0]["zero_stage"])
    ws = optim_states[0]["partition_count"]
    if isinstance(ws, (list, tuple)):
        ws = max(int(w) for w in ws)
    ws = int(ws)
    if ws != len(optim_files):
        raise ValueError(f"partition_count {ws} != {len(optim_files)} optim files under {d}")

    out = {}
    ms0 = model_states[0]
    # buffers ride the module state dict (reference parse_model_states)
    for name in ms0.get("buffer_names", ()):
        out[name] = _fp32(ms0["module"][name])

    param_shapes = ms0["param_shapes"]
    if isinstance(param_shapes, dict):
        param_shapes = [param_shapes]

    if stage <= 2:
        flat_groups = [[_fp32(g) for g in sd["single_partition_of_fp32_groups"]] for sd in optim_states]
        # frozen params are saved whole on rank 0
        for name, frag in (ms0.get("frozen_param_fragments") or {}).items():
            out[name] = _fp32(frag).reshape(_shape_tuple(ms0["frozen_param_shapes"][name]))
        for gi, shapes in enumerate(param_shapes):
            full = torch.cat([flat_groups[r][gi] for r in range(ws)])
            offset = 0
            for name, shape in shapes.items():
                n = _shape_numel(shape)
                out[name] = full[offset:offset + n].reshape(_shape_tuple(shape)).clone()
                offset += n
            align = 2 * ws
            if align * -(-offset // align) != align * -(-full.numel() // align):
                raise ValueError(f"group {gi}: consumed {offset} of {full.numel()} numels")
    elif stage == 3:
        # one flat tensor per group per rank; groups merge (reference
        # parse_optim_states), then params zip rank fragments
        flats = [torch.cat([_fp32(g) for g in sd["fp32_flat_groups"]]) for sd in optim_states]
        for name, shape in (ms0.get("frozen_param_shapes") or {}).items():
            frags = [_fp32(ms["frozen_param_fragments"][name]) for ms in model_states]
            out[name] = torch.cat(frags)[:_shape_numel(shape)].reshape(_shape_tuple(shape))
        merged = {k: v for d_ in param_shapes for k, v in d_.items()}
        offset = 0
        for name, shape in merged.items():
            n = _shape_numel(shape)
            part = -(-n // ws)  # ceil: per-rank fragment length
            frags = [flats[r][offset:offset + part] for r in range(ws)]
            out[name] = torch.cat(frags)[:n].reshape(_shape_tuple(shape))
            offset += part
    else:
        raise ValueError(f"unsupported zero stage {stage}")

    # tied/shared params point at their storage twin. The reference WRITER
    # stores no explicit list — its reader derives pairs by comparing
    # data_ptr() across the module state dict (zero_to_fp32.py:123-131);
    # mirror that, keeping an explicit "shared_params" key as a fallback.
    trained = set(out)
    module_sd = ms0.get("module") or {}
    for name, t in module_sd.items():
        if name in trained or not hasattr(t, "data_ptr"):
            continue
        for partner, pt in module_sd.items():
            if (partner != name and partner in out and hasattr(pt, "data_ptr")
                    and pt.data_ptr() == t.data_ptr()):
                out[name] = out[partner]
                break
    for pair in ms0.get("shared_params", ()) or ():
        if pair[1] in out:
            out[pair[0]] = out[pair[1]]
    logger.info(f"zero_to_fp32: stage {stage}, dp={ws}, {len(out)} tensors consolidated")
    return out


def load_universal_checkpoint_params(checkpoint_dir, tag=None):
    """{name: fp32 tensor} from a universal-checkpoint folder
    (``<tag>/zero/<param_name>/fp32.pt``, reference
    ``checkpoint/universal_checkpoint.py:12``)."""
    d = _resolve_tag_dir(checkpoint_dir, tag)
    zero_dir = os.path.join(d, "zero")
    if not os.path.isdir(zero_dir):
        raise FileNotFoundError(f"{d}: no zero/ folder (not a universal checkpoint)")
    out = {}
    for param_dir in sorted(glob.glob(os.path.join(zero_dir, "*"))):
        fp32 = os.path.join(param_dir, "fp32.pt")
        if os.path.isfile(fp32):
            out[os.path.basename(param_dir)] = _fp32(_torch_load(fp32))
    if not out:
        raise FileNotFoundError(f"{zero_dir}: no <param>/fp32.pt entries")
    return out


def _needs_module_inject(what):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({_MODULE_INJECT})")


def load_megatron_3d_state_dict(checkpoint_dir, tag=None, version=0):
    raise _needs_module_inject("Megatron-DeepSpeed 3D checkpoints")


def megatron_3d_checkpoint_to_params(checkpoint_dir, model_config, tag=None, version=0):
    raise _needs_module_inject("Megatron-DeepSpeed 3D checkpoints")


def export_reference_fp32(params, hf_config, out_path, **overrides):
    raise _needs_module_inject("exports through the injection policies")


def reference_checkpoint_to_params(checkpoint_dir, hf_config, tag=None, dtype=None, **overrides):
    raise _needs_module_inject("imports through the injection policies")
