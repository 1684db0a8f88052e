"""Op builders: the discoverable native/kernel op surface.

Port of ``deepspeed_tpu/ops/op_builder/__init__.py`` (reference
``op_builder/``: ``OpBuilder`` with its CUDA arch probing, JIT nvcc builds
and ``.load()`` import protocol). The builder names are kept, so
``deepspeed.ops.op_builder.SparseAttnBuilder().load()`` ports unchanged. A
builder is a module path and, for an op the port does not have yet, the
ROADMAP item that brings it: ``load()`` raises naming it and
``is_compatible()`` is False. The module owns the list of CUDA sources under
``ops/csrc`` it launches (its ``SOURCES``); ``load()`` compiles them with
``ops/build.py`` for ``sm_90a`` when a card is present, else they build at
the first launch. The offload tiers' host modules (``cpu_adam``,
``cpu_adagrad``, ``async_io``) name one host C source (their ``SOURCE``);
``load()`` builds it with the host C compiler (``load_library()``), and a
failed build raises.
"""

import importlib

from .. import build


class OpBuilder:
    """name + module path (+ the ROADMAP item of an op still to port)."""

    NAME = "base"
    MODULE = None
    ROADMAP = None

    def absolute_name(self):
        return self.MODULE

    def builder_name(self):
        return type(self).__name__

    def is_compatible(self, verbose=False):
        """The module imports (nothing is compiled)."""
        try:
            self._import()
            return True
        except Exception:
            return False

    def _import(self):
        if self.ROADMAP is not None:
            raise RuntimeError(f"{self.NAME}: not ported yet (ROADMAP {self.ROADMAP})")
        return importlib.import_module(self.MODULE)

    def sources(self):
        """The CUDA sources the module launches, as the module names them."""
        return tuple(getattr(self._import(), "SOURCES", ()))

    def load(self, verbose=False):
        """Import the module and build its host C library if it has one;
        with a card, also build its CUDA sources (a failed build raises)."""
        mod = self._import()
        if hasattr(mod, "load_library"):
            mod.load_library()
        sources = getattr(mod, "SOURCES", ())
        if sources:
            import torch
            if torch.cuda.is_available():
                build.build_all(list(sources))
        return mod


class CPUAdamBuilder(OpBuilder):
    NAME = "cpu_adam"
    MODULE = "deepspeed_tpu_torch.ops.adam.cpu_adam"


class CPUAdagradBuilder(OpBuilder):
    NAME = "cpu_adagrad"
    MODULE = "deepspeed_tpu_torch.ops.adam.cpu_adam"  # shared native lib (ds_adagrad_step)


class AsyncIOBuilder(OpBuilder):
    NAME = "async_io"
    MODULE = "deepspeed_tpu_torch.ops.aio"


class QuantizerBuilder(OpBuilder):
    NAME = "quantizer"
    MODULE = "deepspeed_tpu_torch.ops.quantizer"


class FlashAttnBuilder(OpBuilder):
    NAME = "flash_attn"
    MODULE = "deepspeed_tpu_torch.ops.flash_attention"


class InferenceBuilder(OpBuilder):
    """The decode-attention serving kernel (its module, as in JAX)."""
    NAME = "transformer_inference"
    MODULE = "deepspeed_tpu_torch.ops.decode_attention"


class SparseAttnBuilder(OpBuilder):
    NAME = "sparse_attn"
    MODULE = "deepspeed_tpu_torch.ops.sparse_attention"


class RandomLTDBuilder(OpBuilder):
    NAME = "random_ltd"
    MODULE = "deepspeed_tpu_torch.runtime.data_pipeline.data_routing"
    ROADMAP = "Queue 1 #10"  # the tail: runtime/data_pipeline


ALL_OPS = {
    b.NAME: b for b in (CPUAdamBuilder(), CPUAdagradBuilder(), AsyncIOBuilder(),
                        QuantizerBuilder(), FlashAttnBuilder(), InferenceBuilder(),
                        SparseAttnBuilder(), RandomLTDBuilder())
}


def get_default_compute_capabilities():
    """Reference API shape: the visible cards' compute capabilities, e.g.
    ``"9.0"``; without a card, the one the kernels are built for (sm_90a)."""
    import torch
    if not torch.cuda.is_available():
        return "9.0"
    caps = sorted({"%d.%d" % torch.cuda.get_device_capability(i)
                   for i in range(torch.cuda.device_count())})
    return ";".join(caps)
