"""Training engine.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``; analogue
of the reference ``deepspeed/runtime/engine.py``) at ZeRO stages 0-3, on
one device or data-parallel over the ranks of a ``torch.distributed`` world
(``comm``). The JAX engine compiles one fused train step; the port runs the
same step eagerly, in the same order:

1. per microbatch, cast the fp32 master tensors to the compute dtype inside
   the differentiated function, run the model's loss (flash attention's
   forward and backward are the CUDA kernels on the card) and accumulate the
   fp32 gradients;
2. unscale by ``loss_scale * gas`` (times the predivide factor with
   ``prescale_gradients``), take the fp32 global norm, skip the update and
   the step count on a non-finite norm, clip by ``min(1, clip / (norm +
   1e-6))``, run the optimizer (``runtime/optimizers.py``: Adam/AdamW,
   Adagrad, LAMB, SGD, Lion, or a client ``torch.optim.Optimizer``) at the
   learning rate of the applied-step count, and update the loss scaler.

The ``activation_checkpointing`` section sets the model's remat policy (the
JAX engine's rule: a ``policy``, ``partition_activations`` or
``cpu_checkpointing`` turns it on, ``nothing_saveable`` by default). With
``dropout > 0`` each micro-step's loss gets a dropout key folded from the
config seed, the applied-step count and the micro-step index (the JAX
engine's ``fold_in``s), so the fused path and the facade draw the same
masks and a resumed run the uninterrupted run's.

Checkpoints (``save_checkpoint`` / ``load_checkpoint`` /
``wait_checkpoint_saves``, ``runtime/checkpoint_engine``) hold the fp32
master, the optimizer state, the loss scaler, the step counters, the lr
schedule, the config and the client state; never the facade's gradient
accumulator. ``save_16bit_model`` writes the compute-dtype state dict.

The overflow flag is read on the host once per step (the JAX engine selects
on the device). Master weights, gradients and the Adam moments stay fp32 on
the device.

Data and expert parallelism (the JAX engine's mesh, ``comm.initialize_mesh``
with the config's ``mesh.expert_parallel_size`` and the data degree the
world leaves): each rank of the expert x data group trains on its rows of
the global batch (micro-step g's rows ``[r * micro, (r + 1) * micro)`` of
the global micro-batch, the JAX layout). A model whose ``loss`` takes
``n_valid`` gets the global valid-token count (all-reduced first, as the
JAX loss divides by the global ``sum(valid)``) and its share of the MoE aux
term, so the ranks' losses sum to the JAX loss; dense gradients are then
summed over expert x data, the experts' (``moe/layer.py``: a rank holds its
E/ep of them) over data only, and the clip norm is global. Every replica
applies the same update to the same values, so replicas stay bitwise equal.
Another loss function gets the mean of the ranks' losses and gradients.

ZeRO stages (``zero_optimization.stage``; the JAX engine's sharding rules,
``runtime/zero/sharding.py``, with the collectives run here): each tensor's
spec comes from :class:`~.zero.sharding.ShardingPlanner` on its global
logical shape (the model's tensor-parallel rules, then the data-parallel
axes on the largest divisible dim; a split expert axis's experts over
``data`` only).

- Stage >= 1: the fp32 master and every optimizer moment hold this rank's
  shard (``master_spec``); each micro-step casts the shards to the compute
  dtype and all-gathers them whole (stages 1 and 2), takes the gradient
  there and casts it to fp32. At stage 1 the whole gradients are reduced
  and normed as at stage 0, then sliced: bitwise stage 0.
- Stage >= 2: each micro-step's fp32 gradient is reduced over its group and
  scattered to this rank's shard (``grad_spec``); the clip norm sums each
  shard's squares over its group (a split expert axis's experts over
  ``expert`` too), replicated tensors once.
- Stage 3: a model with the streaming protocol runs a block at a time
  (``runtime/zero/stage3.py``: gather before the block, drop after,
  re-gather in the backward through saved-tensor hooks, the next block
  prefetched on a side stream with ``overlap_comm``); another loss gathers
  every tensor at the micro-step's start.
- The optimizers step shards (``runtime/optimizers.py``: LAMB's trust
  ratio sums the shards' squared norms); checkpoints hold global logical
  tensors, gathered one at a time and written by rank 0, and load at any
  stage on the same world size; ``save_16bit_model`` gathers one tensor at
  a time.

Tensor parallelism (``mesh.tensor_parallel_size``; the JAX engine's
Megatron rules, ``tp_rules()`` with ``bitwise_tp`` off): the model is
rebuilt on this rank's shard (``models/transformer.py``: its q/k/v heads,
up/gate columns and vocab rows; o_proj and down_proj row-parallel, their
outputs summed over ``tensor`` before the bias; the vocab-parallel cross
entropy) and the master holds that shard. The ranks of a tensor group see
the same rows, so the data-parallel group (expert x data) and the ZeRO
axes leave ``tensor`` out: each stage shards and gathers over the data
axes only, and stage 3 gathers a block's tensor shards, never the whole
tensors. A tensor replicated over ``tensor`` (a norm, a row-parallel bias)
gets the same gradient on every rank of the group (the region operators
sum what a shard's backward left partial), so it needs no reduction; the
clip norm sums the shards' squares over ``tensor`` and counts a replicated
tensor once. Checkpoints gather each tensor whole over the data axes, then
over ``tensor``, and a load slices it to the engine's own mesh. A degree
that does not divide the head counts raises (the JAX package pads
unevenly); the offload tiers refuse tp > 1.

Telemetry (the JAX engine's wiring): one :class:`TelemetrySink` is the
single reporting call site; its gauges fan out to the ``tensorboard``,
``csv_monitor`` and ``wandb`` monitors, and with ``telemetry.enabled`` each
step records a ``step`` span (synchronized on the card) and every report
interval the ``throughput/samples_per_sec`` and ``mfu`` gauges (MFU by
``bench.py::_mfu``'s 6 N + 12 L H T FLOPs a token over the compute dtype's
peak), the memory watermarks and, each step, the comm overlap tracker's
``comm/{op}/realized_ms``, ``comm/{op}/dispatch_ms`` and
``comm/overlap_efficiency`` (the batch placement as ``host_to_device``,
stage 3's gathers as ``all_gather``; ``comm/overlap.py``). With
objectives in ``telemetry.slo`` the SLO engine evaluates at each report;
``request_profile()`` arms a ``torch.profiler`` capture that starts at the
next one.

Offload tiers (the JAX engine's ``engine.py:163-192``, ``:409-444``,
``:930-1028``, ``:1249-1290``):

- ``zero_optimization.offload_optimizer.device`` ``"cpu"`` or ``"nvme"``
  (ZeRO-Offload, ``runtime/zero/offload.py``,
  ``runtime/swap_tensor/optimizer_swapper.py``): the fp32 master and the
  Adam moments live on the host (or in files under ``nvme_path``), the
  device holds the compute-dtype weights. A step runs the micro-batches'
  forward and backward on the device against those weights; the gradients
  ship at the compute dtype (with ``gas`` > 1 they accumulate in fp32 on
  the device and are cast before shipping), their fp32 norm decides the
  overflow skip and the clip coefficient, and the native C AdamW steps the
  host state, whose bf16 cast is pushed back.
- ``zero_optimization: {stage: 3, offload_param: {device: "cpu" | "nvme"}}``
  (ZeRO-Infinity, ``runtime/zero/param_offload.py``): the parameters live on
  the host too and stream through the step one layer block at a time
  (``param_stream``: ``train_batch``, ``eval_batch``, ``generate``).
  ``offload_param`` subsumes ``offload_optimizer`` and requires stage 3.

Across ranks ZeRO-Offload's host (or NVMe file set, one a rank) holds and
steps only this rank's partition (``offload_spec``, at any stage): the
gradient is reduced and scattered to it before it ships, and the pushed
compute-dtype cast is all-gathered. ZeRO-Infinity keeps the whole store on
every rank and sums each block's gradient over the ranks before the host
step.

Both refuse the forward/backward/step facade; checkpoints keep the
on-device format (the master under ``master``, the moments as an AdamW
state under ``optimizer``), so one saved by any tier loads into any other.

Pipeline parallelism (``mesh.pipeline_parallel_size``; the JAX engine's
``engine.py:710-800``): the mesh is pipe x expert x data x tensor and each
rank builds and holds only its stage's layers (``layers.{i}.*`` on stage
``i // (L / S)``, ``ShardingPlanner.pipe_stage``) plus the embed and head
tensors, replicated over ``pipe``. ``train_batch`` runs the step's
microbatches through ``runtime/pipe/schedule.py`` (``fill_drain`` or
``one_f_one_b``, the ``pipeline.schedule`` section: ``auto`` takes 1F1B
unless fp16, tp > 1, an MoE model or a masked batch) with the model's stage
(``runtime/pipe/stage.py``), exchanging activations and their gradients
over ``pipe`` (``comm.ppermute``). The ZeRO stages run over the data axes
within each stage (stage 3 through a ``BlockGatherer`` of the stage's
blocks). Each replicated tensor's gradient is summed over ``pipe`` before
the update (the reference's ReduceTiedGrads), so every stage applies the
same update; the clip norm counts each stage's layers once (their squares
summed over ``pipe``) and each replicated tensor once, so an fp16 overflow
is seen on every stage; the loss is summed over ``pipe`` (the last stage's
cross entropy and each stage's MoE aux share), so every rank returns it.
``eval_batch`` runs the forward pipeline on one microbatch. Checkpoints are
written in the one-stage format: each layer is fetched from its stage to
rank 0. The forward/backward/step facade and the offload tiers raise under
``pipe``, as in the JAX engine.

Sequence parallelism (``mesh.sequence_parallel_size``; the JAX engine's
``engine.py:1074-1101``): the mesh is pipe x expert x data x seq x tensor,
the model is rebuilt on this rank's chunk of the sequence
(``models/transformer.py::seq_shard_config``: global positions and dropout
rows, Ulysses or ring attention over ``seq``), and every micro-batch's
sequence dim splits over ``seq`` after its shifted labels are built
(position t's label is token t + 1; the last position's is ignored), so no
label is lost at a chunk boundary. The valid-token count, the loss and
every gradient are summed over the data axes and ``seq``; the ZeRO stages
shard over the data axes only (seq ranks hold replicas, as the JAX planner
places them), so the clip norm and the checkpoints are those of the data
axes. Under ``pipe`` the schedule is fill-drain (1F1B refuses ``seq``, as
in JAX). An MoE model's capacity gating runs over expert x data x seq in
the global token order (``moe/sharded_moe.py``). The offload tiers refuse
``seq`` (a leftover of #7.4).

Model contract: ``model.loss(params, batch, **kw)`` over a flat state dict
(``deepspeed_tpu_torch.models`` models have it), or a callable
``loss_fn(params, batch)``; the pipeline needs the streaming protocol
(``stream_plan``, ``stream_embed``, ``stream_layer``, ``stream_tail_loss``)
and ``pipeline_layers``, sequence parallelism a model with ``seq_shard``.
Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the offload tiers at tp > 1 (#7.2) or sp > 1 (#7.4), 1-bit
optimizers, a resume at another world size (#9), ``deepspeed_io``.
"""

import inspect
import math
import os
import time
import weakref

import numpy as np
import torch

from .. import comm as dist
from ..comm.overlap import get_overlap_tracker
from ..accelerator import get_accelerator, resolve_device
from ..monitor.monitor import MonitorMaster
from ..telemetry import SLOEngine, TelemetrySink, set_sink
from ..telemetry.profiler import TorchProfiler
from ..utils.counter_hash import fold_in, seed_key
from ..utils.logging import log_dist, logger
from .checkpoint_engine import engine as ckpt
from .config import DeepSpeedConfig
from .fp16.loss_scaler import LossScaleState, create_loss_scaler
from .lr_schedules import get_lr_schedule, _LRSchedule
from .optimizers import ClientOptimizer, build_optimizer, tensor_norms
from .zero.sharding import ShardingPlanner, entry_axes, shard, shard_group, sharded_dims, unshard

# the gradient all-reduce's flat buffers: about this many bytes each
_REDUCE_BUCKET_BYTES = 1 << 28


def _canon(axes):
    """``axes`` without repeats, in the mesh's order (so every rank names a
    group the same way)."""
    return tuple(a for a in dist.MESH_AXES if a in axes)


def _unported(what, item):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({item})")


def _resolve_loss_fn(model):
    if hasattr(model, "loss") and callable(model.loss):
        return model.loss
    if callable(model):
        return model
    raise ValueError(f"Cannot resolve a loss function from model of type {type(model)}")


class DeepSpeedEngine:

    def __init__(self,
                 model,
                 config=None,
                 config_class=None,
                 optimizer=None,
                 model_parameters=None,
                 training_data=None,
                 lr_scheduler=None,
                 mpu=None,
                 dist_init_required=None,
                 collate_fn=None,
                 device=None):
        self.module = model
        self.loss_fn = _resolve_loss_fn(model)
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.device = resolve_device(device)
        self._config = config_class if config_class is not None else DeepSpeedConfig(config, mpu)

        zero = self._config.zero_optimization
        self.offload_param = zero.offload_param.device in ("cpu", "nvme")
        self.offload_optimizer = zero.offload_optimizer.device in ("cpu", "nvme")
        if self.offload_param:
            if zero.stage != 3:
                raise ValueError("offload_param requires zero stage 3 (reference zero/stage3.py:463 "
                                 "configures param swapping under stage 3 only)")
            if not hasattr(model, "stream_plan"):
                raise ValueError("offload_param requires a model exposing the parameter streaming "
                                 "protocol (stream_plan/stream_embed/stream_layer/stream_tail_loss — "
                                 "deepspeed_tpu_torch.models transformers do)")
            if self.offload_optimizer:
                log_dist("offload_param subsumes offload_optimizer: the streamed step keeps fp32 "
                         "master + moments host-resident by construction", [0])
                self.offload_optimizer = False
        if zero.offload_optimizer.device == "nvme" and self.offload_optimizer and \
                not zero.offload_optimizer.nvme_path:
            raise ValueError("offload_optimizer.device='nvme' requires nvme_path")
        if self._config.mesh.pipeline_parallel_size > 1:
            # the JAX engine's refusals (engine.py:168-170, :182-184)
            if self.offload_param:
                raise NotImplementedError("offload_param does not compose with pipeline_parallel_size > 1")
            if self.offload_optimizer:
                raise NotImplementedError("offload_optimizer does not yet compose with "
                                          "pipeline_parallel_size > 1")
        if training_data is not None:
            raise _unported("deepspeed_io / training_data", "ROADMAP Queue 1 #10, runtime/data_pipeline")
        self.training_dataloader = None

        # ---- data and expert parallelism, the ZeRO plan ----------------------
        model = self._configure_parallel(model)
        self.module = model
        self.loss_fn = _resolve_loss_fn(model)
        self.zero_stage = 0 if self.offload_param else zero.stage
        self.planner = ShardingPlanner(dist.get_mesh() if dist.is_initialized() else {}, zero,
                                       tp_rules=model.tp_rules() if hasattr(model, "tp_rules") else None,
                                       expert_pattern=model.expert_pattern() if hasattr(model, "expert_pattern")
                                       else None,
                                       pipe_pattern=model.pipeline_pattern() if self._pp > 1 else None,
                                       num_layers=getattr(getattr(model, "cfg", None), "num_layers", None))

        # ---- precision ---------------------------------------------------
        self.compute_dtype = self._config.compute_dtype
        self.loss_scaler = create_loss_scaler(self._config.fp16 if self._config.fp16.enabled else None)
        self.dynamic_loss_scale = self._config.dynamic_loss_scale
        self.loss_scale_state = self.loss_scaler.init_state()

        # ---- remat policy and dropout --------------------------------------
        self._configure_remat(model)
        cfg = getattr(model, "cfg", None)
        self._dropout = getattr(cfg, "dropout", 0.0) > 0
        self._base_key = seed_key(self._config.seed)

        # ---- params, optimizer, schedule ---------------------------------
        self.host_opt = self.param_stream = None
        if (self.offload_optimizer or self.offload_param) and optimizer is not None:
            raise ValueError("a client optimizer does not compose with offload_optimizer/offload_param "
                             "(the host step is the native C AdamW)")
        if self.offload_param:
            self.master, self.optimizer = None, None
        elif self.offload_optimizer:
            self.master = self._init_host_optimizer(model, model_parameters)
            self.optimizer = None
        else:
            self.master = self._init_params(model, model_parameters)
            self.optimizer = build_optimizer(self._config.optimizer, self.master,
                                             scanned=getattr(cfg, "scan_layers", False), client=optimizer,
                                             norm_reduce=self._lamb_norm_reduce())
        self._stage3 = self._pipe_gatherer = None
        if self._pp > 1:
            self._configure_pipe(model)
        elif self._config.pipeline:
            self._config.pipeline_schedule()  # one stage: the section is checked, and has no effect
        if self._pp == 1 and self.zero_stage == 3 and self.master is not None:
            if hasattr(model, "stream_plan"):
                from .zero.stage3 import Stage3Loss
                self._stage3 = Stage3Loss(self, model)
            else:
                log_dist("ZeRO stage 3: the model has no parameter-streaming protocol (stream_plan/"
                         "stream_embed/stream_layer/stream_tail_loss), so each micro-step gathers every "
                         "tensor at its start and frees them after its backward", [0])
        self.lr_schedule_fn, self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        if self.offload_param:
            from .zero.param_offload import ParamStreamRunner
            self.param_stream = ParamStreamRunner(model, self._config, self.device, self.compute_dtype,
                                                  self.lr_schedule_fn, seed=self._config.seed,
                                                  params=model_parameters)
        self.last_offload_times = None
        self.step_count = 0  # applied (not overflow-skipped) updates
        self.skipped_steps = 0
        self.loaded_checkpoint_tag = None

        # ---- facade state -------------------------------------------------
        self._grad_acc = None
        self._micro_step = 0
        self._pending_losses = []
        self._last_metrics = None

        # ---- monitor / telemetry ------------------------------------------
        # the sink is the single reporting call site: gauges fan out to the
        # monitor backends; file output only with telemetry.enabled
        self.monitor = MonitorMaster(self._config)
        self.telemetry = TelemetrySink(self._config.telemetry, monitor=self.monitor)
        if self.telemetry.enabled:
            set_sink(self.telemetry)
        self._last_step_dur = None
        self._step_flops = None
        self._facade_t0 = None
        self._slo = None
        if self.telemetry.enabled and self.telemetry.slo_config.get("objectives"):
            self._slo = SLOEngine(self.telemetry, self.telemetry.slo_config)
        # on-demand captures start at the next report boundary, never
        # mid-step; telemetry.profile_report_s > 0 arms one at start
        self.profiler = None
        if self.telemetry.enabled:
            self.profiler = TorchProfiler(self.telemetry.output_path)
            auto_s = float(self._config.telemetry.profile_report_s or 0.0)
            if auto_s > 0:
                self.profiler.request(auto_s)

        n_params = self.param_stream.store.num_params() if self.param_stream is not None else \
            sum(p.numel() for p in self.master.values())
        log_dist(
            f"DeepSpeedEngine ready: device={self.device} zero_stage={zero.stage} "
            f"dtype={self.compute_dtype} micro_bs={self.train_micro_batch_size_per_gpu()} "
            f"gas={self.gradient_accumulation_steps()} params={n_params:,}", [0])

    # ------------------------------------------------------------------ config accessors
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_optimization.stage

    def zero_optimization(self):
        return self._config.zero_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    def bfloat16_enabled(self):
        return self._config.bf16.enabled

    def fp16_enabled(self):
        return self._config.fp16.enabled

    def dp_world_size(self):
        return self._dp

    @property
    def config(self):
        return self._config

    @property
    def params(self):
        """The fp32 master state dict (live tensors, updated in place); under
        ``offload_optimizer`` the device's compute-dtype weights."""
        return self.master

    def get_lr(self):
        return [float(self.lr_schedule_fn(self.global_steps))]

    def loss_scale(self):
        return float(self.loss_scale_state.cur_scale)

    # ------------------------------------------------------------------ init helpers
    def _configure_parallel(self, model):
        """Pipe, tensor, sequence, data and expert parallelism over the live
        world: the mesh (pipe x expert x data x seq x tensor), this rank's
        rows and pipe stage, for an MoE model the model rebuilt on this
        rank's experts, at tp > 1 on this rank's tensor shard and at sp > 1
        on its chunk of the sequence. Returns the model to train."""
        m = self._config.mesh
        tp, ep, data = m.tensor_parallel_size, m.expert_parallel_size, m.data_parallel_size
        pp, sp = m.pipeline_parallel_size, m.sequence_parallel_size
        self._tp, self._pp, self._sp, self._stage = tp, pp, sp, 0
        self._dp = ep * data
        self._dp_rank = self._seq_rank = 0
        # the ranks that share a step's loss and sum its gradients: the
        # data axes, and seq (each seq rank holds a chunk of the tokens)
        seq = (dist.SEQ_AXIS, ) if sp > 1 else ()
        self._loss_axes = _canon(dist.DP_AXES + seq)
        self._loss_world = self._dp * sp
        self._grad_axes = self._loss_axes  # dense tensors
        self._expert_grad_axes = _canon((dist.DATA_AXIS, ) + seq)  # a split expert axis's experts
        self._tp_dims = {}  # master key -> the dim split over tensor (tp > 1)
        self._expert_mask = None  # per master tensor: an expert of a split expert axis
        self._sharded = False  # the master is this rank's shards (ZeRO stage >= 1 over ranks)
        self._offload_sharded = False  # ZeRO-Offload's host state is this rank's partition
        self._global_loss = "n_valid" in inspect.signature(self.loss_fn).parameters
        if pp > 1:
            for need in ("stream_plan", "pipeline_layers"):
                if not hasattr(model, need):
                    raise ValueError("pipeline_parallel_size > 1 needs a deepspeed_tpu_torch model (the streaming "
                                     "protocol and pipeline_layers): a loss function alone has no stages")
        if self._dp * tp * pp * sp == 1 and not dist.is_initialized():
            return model
        if self._dp * tp * pp * sp != dist.get_world_size():
            raise ValueError(f"pipe x tensor x seq x expert x data = {pp} x {tp} x {sp} x {ep} x {data} does not "
                             f"cover the world of {dist.get_world_size()} ranks")
        mesh = dist.get_mesh() if dist.has_mesh() else None
        axes = (dist.PIPE_AXIS, dist.EXPERT_AXIS, dist.DATA_AXIS, dist.SEQ_AXIS, dist.TENSOR_AXIS)
        if mesh is None or tuple(mesh.shape[a] for a in axes) != (pp, ep, data, sp, tp):
            dist.initialize_mesh(pipe=pp, expert=ep, data=data, seq=sp, tensor=tp)
        self._dp_rank = dist.get_rank(dist.DP_AXES)
        self._seq_rank = dist.get_rank(dist.SEQ_AXIS)
        self._stage = dist.get_rank(dist.PIPE_AXIS)
        if pp > 1:
            model.pipeline_layers(self._stage, pp)  # raises for a depth the degree does not divide
        if pp > 1 or sp > 1:
            # a group is built by every rank at its first use; the stages of a
            # step first use theirs at different points, so build them now
            for axes in (dist.PIPE_AXIS, dist.EXPERT_AXIS, dist.DATA_AXIS, dist.SEQ_AXIS, dist.TENSOR_AXIS,
                         dist.DP_AXES, self._loss_axes, self._expert_grad_axes):
                dist.get_mesh().process_group(axes)
        cfg = getattr(model, "cfg", None)
        if getattr(cfg, "num_experts", 0) > 0:
            from ..moe.layer import shard_config
            sharded = shard_config(cfg)
            if sharded != cfg:
                model = type(model)(sharded)
        if tp > 1:
            model = self._tp_model(model)
        if sp > 1:
            model = self._seq_model(model)
        return model

    def _seq_model(self, model):
        """The model rebuilt on this rank's chunk of the sequence."""
        from ..models.transformer import seq_shard_config
        sp = self._sp
        if self.offload_optimizer or self.offload_param:
            raise _unported(f"the offload tiers at sequence_parallel_size={sp} (ZeRO-Offload and ZeRO-Infinity "
                            f"run the whole sequence)", "ROADMAP Queue 1 #7.4, its leftover")
        if not hasattr(getattr(model, "cfg", None), "seq_shard"):
            raise ValueError("sequence_parallel_size > 1 needs a deepspeed_tpu_torch model (a config with "
                             "seq_shard): a loss function alone cannot place a chunk of the sequence")
        return type(model)(seq_shard_config(model.cfg, sp))

    def _tp_model(self, model):
        """The model rebuilt on this rank's tensor shard (Megatron rules:
        ``bitwise_tp`` off)."""
        from ..models.transformer import tp_shard_config
        tp = self._tp
        if self.offload_optimizer or self.offload_param:
            raise _unported(f"the offload tiers at tensor_parallel_size={tp} (ZeRO-Offload and "
                            f"ZeRO-Infinity hold whole tensors)", "ROADMAP Queue 1 #7.2, its leftover")
        if not hasattr(model, "tp_rules"):
            raise ValueError("tensor_parallel_size > 1 needs a deepspeed_tpu_torch model (a config and "
                             "tp_rules()): a loss function alone has no tensor shards")
        # the config raises for head counts the degree does not divide (the
        # JAX package pads them unevenly)
        return type(model)(tp_shard_config(model.cfg, tp, bitwise=False))

    def _tp_slice(self, k, t):
        """This rank's tensor shard of a whole tensor ``k`` (``t`` at tp 1
        or for a replicated tensor)."""
        from ..models.transformer import tp_slice
        return tp_slice(t, self._tp_dims.get(k), self.module.cfg)

    def _tp_whole(self, k, t):
        """The whole tensor ``k`` from every tensor rank's shard ``t`` (an
        all-gather over ``tensor``; ``t`` when it is replicated)."""
        d = self._tp_dims.get(k)
        if d is None:
            return t
        return dist.all_gather(t.contiguous(), group=dist.TENSOR_AXIS, axis=d)

    def _configure_remat(self, model):
        """The ``activation_checkpointing`` section as the model's remat
        policy (the JAX engine's ``engine.py:124-143``)."""
        ac = self._config.activation_checkpointing
        if ac.policy is None and not ac.partition_activations and not ac.cpu_checkpointing:
            return
        policy = ac.policy or "nothing_saveable"
        if hasattr(model, "set_remat_policy"):
            if getattr(getattr(model, "cfg", None), "remat_policy", None) != policy:
                model.set_remat_policy(policy)
                log_dist(f"activation checkpointing: remat policy '{policy}' applied", [0])
        else:
            logger.warning("activation_checkpointing configured but the model exposes no "
                           "set_remat_policy(policy) hook — section has NO effect; wrap its blocks in "
                           "runtime.activation_checkpointing.checkpointing.checkpoint yourself")
        if ac.partition_activations:
            log_dist("activation_checkpointing.partition_activations has no effect on one device "
                     "(there is no other device to partition the saved activations over)", [0])

    def _configure_pipe(self, model):
        """The pipeline's schedule (the ``pipeline`` section, the JAX
        engine's rules: ``auto`` takes 1F1B unless fp16, tensor or sequence
        parallelism, an MoE model, or a masked batch; an explicit ``1f1b``
        refuses the first three), this stage's layers and blocks, and at
        ZeRO stage 3 the stage's :class:`BlockGatherer`."""
        from .pipe.stage import stage_blocks
        self._pipe_schedule = self._config.pipeline_schedule()
        fp16, moe = self._config.fp16.enabled, getattr(model.cfg, "num_experts", 0) > 0
        if self._pipe_schedule == "1f1b":
            if fp16:
                # the interleaved backward seeds each microbatch before the
                # dynamic loss scale could skip the step
                raise NotImplementedError("pipeline.schedule='1f1b' does not support fp16 loss scaling; use bf16 "
                                          "(TPU-native) or fill_drain")
            if self._tp > 1 or self._sp > 1:
                raise NotImplementedError("pipeline.schedule='1f1b' composes with pipe x data meshes; use the "
                                          "default fill-drain schedule with tensor/sequence parallelism")
            if moe:
                raise NotImplementedError("1f1b does not carry the MoE aux loss; use the default fill-drain "
                                          "schedule for MoE models")
        if getattr(model.cfg, "scan_layers", False) and str(self._config.optimizer.type or "").lower() == "lamb":
            raise _unported("LAMB's stacked-layer norm groups (scan_layers) across pipe stages",
                            "ROADMAP Queue 1 #7.3, its leftover")
        self._pipe_auto_1f1b = not (fp16 or self._tp > 1 or self._sp > 1 or moe)
        if self._pipe_schedule == "auto":
            log_dist(f"pipeline.schedule=auto -> {'1f1b' if self._pipe_auto_1f1b else 'fill_drain'} "
                     f"(fill_drain for a masked batch)", [0])
        first, last = self._stage == 0, self._stage == self._pp - 1
        self._pipe_layers = model.pipeline_layers(self._stage, self._pp)
        self._pipe_blocks = stage_blocks(model, self._pipe_layers, first, last)
        if self.zero_stage == 3:
            from .zero.stage3 import BlockGatherer
            threshold = self.planner.persistence_threshold
            self._pipe_persistent = [k for k in self.master if math.prod(self._shapes_global[k]) <= threshold]
            keep = set(self._pipe_persistent)
            blocks = {name: [k for k in keys if k not in keep] for name, keys in self._pipe_blocks.items()}
            zero = self._config.zero_optimization
            self._pipe_gatherer = BlockGatherer(self.master, self._specs["master"], self.compute_dtype, blocks,
                                                weakref.WeakMethod(self._reduce_grad), bool(zero.overlap_comm),
                                                False)
            self._pipe_gatherer.shapes = {k: tuple(sh) for k, (sh, _) in model.param_shapes().items()}

    def _init_params(self, model, model_parameters):
        """fp32 master tensors on the device, from ``model_parameters`` (a
        state dict) or ``model.init_params(seed)``."""
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("Provide model_parameters or a model with init_params(seed)")
            init = model
            cfg = getattr(model, "cfg", None)
            if getattr(cfg, "moe_local_experts", None) or getattr(cfg, "tp_shard", None):
                # every rank draws the full tree
                import dataclasses
                init = type(model)(dataclasses.replace(cfg, moe_local_experts=None, tp_shard=None))
            model_parameters = init.init_params(self._config.seed)
        cfg = getattr(model, "cfg", None)
        if getattr(cfg, "moe_local_experts", None):
            from ..moe.layer import shard_params
            model_parameters = shard_params(model_parameters, cfg)
        if self._pp > 1:  # this stage's layers and the tensors replicated over pipe
            self._all_keys = list(model_parameters)
            model_parameters = {k: v for k, v in model_parameters.items()
                                if self.planner.pipe_stage(k) in (None, self._stage)}
        self._plan({k: tuple(np.shape(v)) for k, v in model_parameters.items()})
        master = {}
        for k, v in model_parameters.items():
            whole = torch.as_tensor(v)
            part = self._tp_slice(k, whole)
            full = part.to(self.device, torch.float32)
            if part is not whole and full is part:  # this rank's own copy, not a view of the whole
                full = full.clone(memory_format=torch.contiguous_format)
            mine = shard(full, self._specs["master"][k])
            master[k] = (mine if mine is full else mine.clone(memory_format=torch.contiguous_format))
            master[k].requires_grad_(True)
            del full, mine
        return master

    def _plan(self, shapes):
        """The ZeRO specs of every tensor (``runtime/zero/sharding.py``):
        planned on the global logical shape (a split expert axis's experts
        counted whole), then localized (this rank already holds only its
        experts, so the expert axis drops out of their specs). Sets the
        per-tensor reduction groups and norm groups the step uses.
        ``shapes`` are whole over ``tensor``: at tp > 1 the tensor axis
        drops out of the specs too (the master already holds this rank's
        tensor shard), and a tensor-sharded tensor's norm sums over
        ``tensor``."""
        cfg = getattr(self.module, "cfg", None)
        if self._tp > 1:
            from ..models.transformer import tp_dims
            self._tp_dims = tp_dims(self.module, shapes)
        split = bool(getattr(cfg, "moe_local_experts", None))
        pattern = self.module.expert_pattern() if split else None
        self._expert_mask = [pattern in k for k in shapes] if split else None
        mask = dict(zip(shapes, self._expert_mask or [False] * len(shapes)))
        ep = dist.get_world_size(dist.EXPERT_AXIS) if split else 1
        self._shapes_global = {k: ((shp[0] * ep, ) + tuple(shp[1:])) if mask[k] else tuple(shp)
                               for k, shp in shapes.items()}

        held = (dist.EXPERT_AXIS, dist.TENSOR_AXIS)

        def local(spec, expert):
            if not expert and self._tp == 1:
                return spec
            drop = held if expert else (dist.TENSOR_AXIS, )
            return tuple(None if not a else (tuple(a) if len(a) > 1 else a[0])
                         for a in ([x for x in entry_axes(e) if x not in drop] for e in spec))

        self._specs = {which: {k: local(getattr(self.planner, f"{which}_spec")(k, self._shapes_global[k]), mask[k])
                               for k in shapes}
                       for which in ("param", "master", "grad", "offload")}
        self._red_axes = {k: self._expert_grad_axes if e else self._grad_axes for k, e in mask.items()}
        extra = {k: ((dist.EXPERT_AXIS, ) if e else ()) + ((dist.TENSOR_AXIS, ) if self._tp_dims.get(k) is not None
                                                             else ()) for k, e in mask.items()}
        self._norm_groups = {which: {k: _canon(shard_group(self._specs[which][k]) + extra[k]) for k in shapes}
                             for which in ("master", "grad", "offload")}
        # the clip norm's groups: a stage's layers' squares summed over pipe
        # too (each replicated tensor counts once)
        self._pipe_local = {k: self._pp > 1 and self.planner.pipe_stage(k) is not None for k in shapes}
        pipe = {k: (dist.PIPE_AXIS, ) if local else () for k, local in self._pipe_local.items()}
        self._grad_norm_groups = [_canon(self._norm_groups["grad"][k] + pipe[k]) for k in shapes]
        # the norm groups of whole (data-parallel) gradients at tp > 1 or pp > 1
        self._whole_norm_groups = ([_canon(extra[k] + pipe[k]) for k in shapes] if self._tp > 1 or self._pp > 1
                                   else None)
        self._sharded = any(sharded_dims(sp) for sp in self._specs["master"].values())

    def _init_host_optimizer(self, model, model_parameters):
        """ZeRO-Offload: the fp32 master (``model_parameters`` or
        ``model.init_params(seed)``, as the on-device engine takes it) and
        the moments to the host (or NVMe); returns the device's
        compute-dtype leaves."""
        from .zero.offload import HostOffloadOptimizer
        off = self._config.zero_optimization.offload_optimizer
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("Provide model_parameters or a model with init_params(seed)")
            model_parameters = model.init_params(self._config.seed)
        if off.device == "nvme":
            from .swap_tensor import NVMeOffloadOptimizer, get_aio_config
            self.host_opt = NVMeOffloadOptimizer(self._config.optimizer, self.device, self.compute_dtype,
                                                 off.nvme_path, get_aio_config(self._config.raw_config),
                                                 pipeline_read=bool(off.pipeline_read),
                                                 pipeline_write=bool(off.pipeline_write))
        else:
            self.host_opt = HostOffloadOptimizer(self._config.optimizer, self.device, self.compute_dtype)
        params = {k: torch.as_tensor(v) for k, v in model_parameters.items()}
        self._plan({k: tuple(v.shape) for k, v in params.items()})
        self._sharded = False  # the engine's tensors are the whole compute copy
        spec = self._specs["offload"]
        self._offload_sharded = any(sharded_dims(spec[k]) for k in params)
        # each rank's host holds and steps its partition (offload_spec) only
        leaves = self.host_opt.init({k: shard(v, spec[k]) for k, v in params.items()})
        self._grad_views = list(self.host_opt.views(self.host_opt.dev_grad).values())
        self._offload_acc = None
        if self._offload_sharded:
            self._part_leaves = leaves
            leaves = {k: torch.empty(v.shape, dtype=self.compute_dtype, device=self.device).requires_grad_(True)
                      for k, v in params.items()}
            self._offload_gather(leaves)
        return leaves

    @torch.no_grad()
    def _offload_gather(self, leaves=None):
        """The whole compute copy from every rank's pushed partition (an
        all-gather a tensor, after the push: the current stream waits on
        it)."""
        leaves = self.master if leaves is None else leaves
        spec = self._specs["offload"]
        for k, part in self._part_leaves.items():
            leaves[k].copy_(unshard(part, spec[k]))

    def _configure_lr_scheduler(self, client_lr_scheduler):
        """(step -> lr function, stateful schedule or None); reference
        engine.py:836."""
        sched_cfg = self._config.scheduler
        if client_lr_scheduler is not None:
            if isinstance(client_lr_scheduler, _LRSchedule):
                return client_lr_scheduler.__call__, client_lr_scheduler
            if callable(client_lr_scheduler):
                return client_lr_scheduler, None
            raise ValueError("lr_scheduler must be a deepspeed_tpu_torch schedule or a step->lr callable")
        if sched_cfg.type is not None:
            sched = get_lr_schedule(sched_cfg.type, sched_cfg.params)
            return sched.__call__, sched
        if self.optimizer is None:
            base_lr = float(self._config.optimizer.params.get("lr", 1e-3))
        elif isinstance(self.optimizer, ClientOptimizer):  # a client optimizer keeps its own lr
            base_lr = self.optimizer.lr
        else:
            base_lr = float(self._config.optimizer.params.get("lr", 1e-3))
        return (lambda step: base_lr), None

    # ------------------------------------------------------------------ step math
    def _micro_rng(self, micro):
        """The dropout key of micro-step ``micro`` of the coming update
        (None without dropout): the seed's key folded with the applied-step
        count, then the micro-step."""
        if not self._dropout:
            return None
        return fold_in(fold_in(self._base_key, self.step_count), micro)

    def _micro_loss_and_grads(self, params, batch, scale, rng=None, **loss_kwargs):
        """One microbatch: forward and backward at the compute dtype.
        Returns (loss, gradients of ``loss * scale`` in the dtype of
        ``params``' tensors, one per tensor). ``rng``: the dropout key,
        passed to the loss when given.

        The compute tensors are ``params`` cast inside the differentiated
        function; when the master is this rank's shards (stage >= 1 across
        ranks) they are leaves cast and all-gathered from them instead, and
        the gradient at them is cast back: what the backward of the in-graph
        cast computes, so stages 0 and 1 give the same bits. At stage >= 2
        each gradient is reduced over its data-parallel group and scattered
        to this rank's shard (``grad_spec``); at stage 3 a model with the
        streaming protocol runs a block at a time (``zero/stage3.py``)."""
        if rng is not None:
            loss_kwargs["rng"] = rng
        if self._sp > 1:
            batch = self._seq_split(batch)
        if self._loss_world > 1 and self._global_loss:
            labels = batch["labels"] if "labels" in batch else batch["input_ids"][:, 1:]
            n_valid = dist.all_reduce((labels >= 0).sum(), group=self._loss_axes)
            loss_kwargs.update(n_valid=torch.clamp(n_valid, min=1), aux_share=1.0 / self._loss_world)
        mine = params is self.master and self.host_opt is None
        if mine and self._stage3 is not None:
            return self._stage3(batch, scale, **loss_kwargs)
        keys = list(params)
        if mine and self._sharded:  # the whole compute tensors, gathered from the shards
            with torch.no_grad():
                p_c = {k: unshard(params[k].detach().to(self.compute_dtype), self._specs["master"][k])
                       for k in keys}
            targets = [t.requires_grad_(True) for t in p_c.values()]
        else:  # cast inside the graph: each gradient reaches ``params`` at its dtype as it lands
            p_c, targets = None, [params[k] for k in keys]
        with torch.enable_grad():
            if p_c is None:
                p_c = {k: params[k].to(self.compute_dtype) for k in keys}
            loss = self.loss_fn(p_c, batch, **loss_kwargs)
            grads = torch.autograd.grad(loss.float() * scale, targets, allow_unused=True)
        grads = [torch.zeros(t.shape, dtype=params[k].dtype, device=t.device) if g is None
                 else g.to(params[k].dtype) for k, t, g in zip(keys, targets, grads)]
        del p_c, targets
        if mine and self.zero_stage >= 2:
            grads = [self._reduce_grad(k, g) for k, g in zip(keys, grads)]
        return loss.detach(), grads

    def _seq_split(self, batch):
        """This rank's chunk of a batch's sequence dim (the last), after the
        labels are built: without ``labels`` position t's is token t + 1
        and the last position's is ignored (-100), so the chunks' labels are
        the whole sequence's."""
        ids = batch["input_ids"]
        T, sp, s = ids.shape[-1], self._sp, self._seq_rank
        if T % sp:
            raise ValueError(f"sequence length {T} does not split over sequence_parallel_size={sp}")
        out = dict(batch)
        if "labels" not in out:
            out["labels"] = torch.cat([ids[..., 1:], torch.full_like(ids[..., :1], -100)], dim=-1)
        Tc = T // sp
        for k in ("input_ids", "labels", "attention_mask"):
            if k in out:
                out[k] = out[k][..., s * Tc:(s + 1) * Tc]
        return out

    def _reduce_grad(self, k, g, which="grad"):
        """A whole fp32 gradient of tensor ``k`` reduced over its group
        (``data`` for a split expert axis's experts, expert x data for the
        rest, and ``seq``; the sum with the global valid count, else the
        mean) and scattered to this rank's shard of ``grad_spec``
        (``offload_spec`` for ZeRO-Offload)."""
        if self._loss_world == 1:
            return g
        op = dist.ReduceOp.SUM if self._global_loss else dist.ReduceOp.AVG
        spec = self._specs[which][k]
        shard_axes = shard_group(spec)
        rest = tuple(a for a in self._red_axes[k] if a not in shard_axes)
        if rest:
            g = dist.all_reduce(g, op=op, group=rest)
        for d, axes in sharded_dims(spec):
            g = dist.reduce_scatter(g, op=op, group=axes, scatter_dimension=d)
        return g

    def _grad_denom(self, scale):
        """Loss-scale x gas (x predivide) unscaling denominator."""
        denom = scale * self._config.gradient_accumulation_steps
        if self._config.prescale_gradients:
            denom = denom * self._config.gradient_predivide_factor
        return denom

    def _clip_coef(self, gnorm):
        """Gradient-clipping coefficient, or None when clipping is off."""
        clip = self._config.gradient_clipping
        if clip and clip > 0:
            return min(1.0, clip / (gnorm + 1e-6))
        return None

    def _reduce(self, tensors, group, op):
        """All-reduce a list of tensors in place, as flat buffers of about
        ``_REDUCE_BUCKET_BYTES`` (a whole model's fp32 gradient in one buffer
        would take two more copies of it on the device)."""
        if not tensors or dist.get_world_size(group) == 1:
            return
        start, size = 0, 0
        for i, t in enumerate(tensors):
            size += t.numel() * t.element_size()
            if size >= _REDUCE_BUCKET_BYTES or i == len(tensors) - 1:
                chunk = tensors[start:i + 1]
                flat = dist.all_reduce(torch._utils._flatten_dense_tensors(chunk), op=op, group=group)
                for t_, r in zip(chunk, torch._utils._unflatten_dense_tensors(flat, chunk)):
                    t_.copy_(r)
                del flat
                start, size = i + 1, 0

    @torch.no_grad()
    def _reduce_grads(self, grads, loss_mean):
        """Data and sequence parallelism: sum the ranks' gradients (those of
        a split expert axis's experts over ``data`` and ``seq`` only) and
        their losses, or average both for a loss without the global valid
        count (at stage >= 2 the micro-steps reduced the gradients
        already). Returns the loss."""
        if self._loss_world == 1:
            return loss_mean
        op = dist.ReduceOp.SUM if self._global_loss else dist.ReduceOp.AVG
        if self.zero_stage < 2:
            mask = self._expert_mask or [False] * len(grads)
            self._reduce([g for g, e in zip(grads, mask) if not e], self._grad_axes, op)
            self._reduce([g for g, e in zip(grads, mask) if e], self._expert_grad_axes, op)
        return dist.all_reduce(loss_mean.float(), op=op, group=self._loss_axes)

    def _global_norm(self, grads, groups=None):
        """The fp32 norm of the whole model's gradient. ``groups``: per
        gradient the axes its squares sum over (a shard's group, and
        ``expert`` for a split expert axis's experts); None: whole
        gradients, a split expert axis's experts' squares summed over
        ``expert``, the rest shared."""
        if groups is not None and any(groups):
            by = {}
            for n, grp in zip(tensor_norms(grads), groups):
                by.setdefault(grp, []).append(n)
            total = None
            for grp, norms in by.items():
                sq = torch.stack(norms).square().sum()
                if grp:
                    sq = dist.all_reduce(sq, group=grp)
                total = sq if total is None else total + sq
            return float(torch.sqrt(total))
        if self._expert_mask is None:
            return float(torch.linalg.vector_norm(torch.stack(tensor_norms(grads))))

        def sq(keep):
            return torch.stack([torch.sum(torch.square(g)) for g, e in zip(grads, self._expert_mask)
                                if e == keep]).sum()

        return float(torch.sqrt(sq(False) + dist.all_reduce(sq(True), group=dist.EXPERT_AXIS)))

    def _lamb_norm_reduce(self):
        """LAMB's whole-tensor norms from shards: each sharded tensor's
        squared norm summed over its group (``expert`` too for a split
        expert axis's experts); None when every tensor is whole on this
        rank and no expert axis splits."""
        groups = list(self._norm_groups["master"].values())
        if not any(groups):
            return None

        def reduce(norms):
            out = list(norms)
            by = {}
            for i, grp in enumerate(groups):
                if grp:
                    by.setdefault(grp, []).append(i)
            for grp, idx in by.items():
                sq = dist.all_reduce(torch.stack([norms[i] for i in idx]).square(), group=grp)
                for j, i in enumerate(idx):
                    out[i] = sq[j].sqrt()
            return out

        return reduce

    @torch.no_grad()
    def _apply_grads(self, grads, loss_mean):
        """Reduce over the data-parallel ranks, unscale, norm, overflow skip,
        clip, update (``grads`` is consumed in place). At stage 1 the whole
        reduced gradients give the norm, as at stage 0, and the optimizer
        steps this rank's shard; at stage >= 2 they are shards already."""
        loss_mean = self._reduce_grads(grads, loss_mean)
        scale = self.loss_scale_state.cur_scale
        torch._foreach_div_(grads, self._grad_denom(scale))
        sharded_grads = self.zero_stage >= 2 and self._sharded
        gnorm = self._global_norm(grads, self._grad_norm_groups if sharded_grads else self._whole_norm_groups)
        if self.zero_stage == 1 and self._sharded:
            grads = [shard(g, self._specs["master"][k]) for k, g in zip(self.master, grads)]
        overflow = not math.isfinite(gnorm)
        lr = float(self.lr_schedule_fn(self.step_count))
        if overflow:
            self.skipped_steps += 1
        else:
            coef = self._clip_coef(gnorm)
            if coef is not None:
                torch._foreach_mul_(grads, coef)
            self.optimizer.step(list(self.master.values()), grads, lr)
            self.step_count += 1
        self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
        return {"loss": loss_mean, "grad_norm": gnorm, "lr": lr, "overflow": overflow,
                "loss_scale": scale}

    @torch.no_grad()
    def _offload_apply(self, gnorm_raw, loss_mean):
        """The host half of an offloaded step (the JAX engine's
        ``engine.py:981-1028``): overflow skip, clip, the native AdamW over
        the host state and the push of its bf16 cast."""
        scale = self.loss_scale_state.cur_scale
        denom = self._grad_denom(scale)
        overflow = not math.isfinite(gnorm_raw)
        gnorm = gnorm_raw / denom
        lr = float(self.lr_schedule_fn(self.step_count))
        if overflow:
            self.skipped_steps += 1
            times = {}
        else:
            coef = 1.0 / denom
            clip = self._clip_coef(gnorm)
            if clip is not None:
                coef *= clip
            times = self.host_opt.step(coef, lr)
            if self._offload_sharded:
                self._offload_gather()
            self.step_count += 1
        self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
        return {"loss": loss_mean, "grad_norm": gnorm, "lr": lr, "overflow": overflow,
                "loss_scale": scale}, times

    def _offload_train_batch(self, stacked, gas):
        """ZeRO-Offload step: the micro-batches' forward and backward on the
        device against the compute-dtype weights, gradients shipped at the
        compute dtype (fp32-accumulated on the device when ``gas`` > 1),
        then :meth:`_offload_apply`. Across ranks the fp32 gradients are
        reduced and scattered to this rank's partition (``offload_spec``)
        before they ship, and the norm sums the partitions' squares."""
        t0 = time.perf_counter()
        scale = self.loss_scale_state.cur_scale
        loss_sum = None
        acc = None
        for g in range(gas):
            loss, grads = self._micro_loss_and_grads(self.master, {k: v[g] for k, v in stacked.items()},
                                                     scale, self._micro_rng(g))
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss.float()
            with torch.no_grad():
                if self._dp > 1:
                    if acc is None:
                        acc = [x.float() for x in grads]
                    else:
                        torch._foreach_add_(acc, grads)
                elif gas == 1:
                    torch._foreach_copy_(self._grad_views, grads)
                else:
                    if self._offload_acc is None:
                        self._offload_acc = torch.empty(self.host_opt.n, dtype=torch.float32,
                                                        device=self.device)
                        self._acc_views = list(self.host_opt.views(self._offload_acc).values())
                    if g == 0:
                        torch._foreach_copy_(self._acc_views, grads)
                    else:
                        torch._foreach_add_(self._acc_views, grads)
            del grads
        with torch.no_grad():
            if self._dp > 1:
                parts = [self._reduce_grad(k, a, "offload") for k, a in zip(self.master, acc)]
                del acc
                torch._foreach_copy_(self._grad_views, parts)
                gnorm_raw = self._global_norm(parts, list(self._norm_groups["offload"].values()))
                del parts
                op = dist.ReduceOp.SUM if self._global_loss else dist.ReduceOp.AVG
                loss_sum = dist.all_reduce(loss_sum, op=op, group=dist.DP_AXES)
            elif gas > 1:
                self.host_opt.dev_grad.copy_(self._offload_acc)
                gnorm_raw = self._global_norm(self._acc_views)
            else:
                # per tensor, then over the tensors, as the on-device step
                # norms its gradients: the clipping coefficient, and so the
                # gradient the host AdamW reads, is bitwise that step's
                gnorm_raw = self._global_norm(self._grad_views)
        t1 = time.perf_counter()
        metrics, times = self._offload_apply(gnorm_raw, loss_sum / gas)
        self.last_offload_times = {"device_ms": (t1 - t0) * 1e3,
                                   **{k[:-2] + "_ms": v * 1e3 for k, v in times.items()}}
        return metrics

    # ------------------------------------------------------------------ pipeline
    def _pipe_stage(self, stacked, train=True, scale=1.0, acc=None):
        """This rank's :class:`~.pipe.stage.ModelStage` over ``stacked``
        ((M, micro, ...) leaves): its tensors from the step's compute
        leaves (stages 0-2, gathered whole over the data axes once) or the
        stage's block gatherer (stage 3, training)."""
        from .pipe.stage import GatherSource, LeafSource, ModelStage
        M = stacked["input_ids"].shape[0]
        labels = stacked["labels"] if "labels" in stacked else stacked["input_ids"][:, :, 1:]
        denom = (labels >= 0).sum()
        if train and self._loss_world > 1:
            denom = dist.all_reduce(denom, group=self._loss_axes)
        elif self._sp > 1:  # an evaluated microbatch's count over its sequence
            denom = dist.all_reduce(denom, group=dist.SEQ_AXIS)
        denom = torch.clamp(denom, min=1)
        keys = list(self.master)
        if train and self._pipe_gatherer is not None:
            self._pipe_gatherer.reset()
            self._pipe_gatherer.track = self.telemetry.enabled
            src = GatherSource(self._pipe_gatherer, self.master, self._pipe_persistent)
        else:
            spec = self._specs["master"]
            with torch.no_grad():
                p_c = {k: unshard(v.detach().to(self.compute_dtype), spec[k]) for k, v in self.master.items()}
            if train:
                for t in p_c.values():
                    t.requires_grad_(True)
            src = LeafSource(p_c, keys)
        cfg = self.module.cfg
        return ModelStage(self.module, self._stage, self._pp, self._pipe_layers, self._pipe_blocks, src, stacked,
                          denom, seed=scale, aux_coef=getattr(cfg, "moe_aux_loss_coef", 0.0) / M / self._loss_world,
                          rngs=[self._micro_rng(m) for m in range(M)] if self._dropout and train else None,
                          accumulate=acc, train=train)

    def _pipe_like(self, stacked):
        """(shape, dtype, device) of an activation between stages (the
        model's activation dtype)."""
        b, T = stacked["input_ids"].shape[1:]  # this rank's chunk under seq
        cfg = self.module.cfg
        return (b, T, cfg.hidden_size), cfg.dtype, self.device

    def _pipe_train_batch(self, stacked, gas):
        """A pipelined step: the schedule over this stage, the gradients
        accumulated in microbatch order (fp32; reduced to the shard a
        microbatch at stage 2, in the backward at stage 3), the replicated
        tensors' summed over ``pipe``, then :meth:`_apply_grads`."""
        from .pipe.schedule import fill_drain, one_f_one_b
        keys = list(self.master)
        acc = [None] * len(keys)
        reduce_each = self.zero_stage == 2 and self._pipe_gatherer is None

        def accumulate(m, grads):
            for i, (k, g) in enumerate(zip(keys, grads)):
                if g is None:
                    continue
                g = g.to(self.master[k].dtype)
                if reduce_each:
                    g = self._reduce_grad(k, g)
                acc[i] = g if acc[i] is None else acc[i].add_(g)

        use_1f1b = self._pipe_schedule == "1f1b" or (self._pipe_schedule == "auto" and self._pipe_auto_1f1b
                                                      and "attention_mask" not in stacked)
        if self._sp > 1:
            stacked = self._seq_split(stacked)
        # the engine unscales by loss_scale * gas; the stream's loss is its mean already
        stage = self._pipe_stage(stacked, scale=self.loss_scale_state.cur_scale * gas, acc=accumulate)
        try:
            (one_f_one_b if use_1f1b else fill_drain)(stage, gas, self._pipe_like(stacked))
        finally:
            if self._pipe_gatherer is not None:
                self._pipe_gatherer.finish()
        self.last_pipe = {"schedule": "1f1b" if use_1f1b else "fill_drain", "max_in_flight": stage.max_in_flight}
        with torch.no_grad():
            # a replicated tensor this stage does not touch: zeros, whole
            # below stage 2 (the compute leaf's shape), else the master shard's
            like = stage.src.tensors if self.zero_stage < 2 else self.master
            grads = [torch.zeros(like[k].shape, dtype=self.master[k].dtype, device=self.device) if a is None else a
                     for k, a in zip(keys, acc)]
            self._reduce([g for k, g in zip(keys, grads) if not self._pipe_local[k]], dist.PIPE_AXIS,
                         dist.ReduceOp.SUM)
            loss = dist.all_reduce(stage.loss(), group=dist.PIPE_AXIS)
        return self._apply_grads(grads, loss)

    @torch.no_grad()
    def _pipe_eval(self, batch):
        """The forward pipeline on one microbatch (``batch``'s rows): the
        loss, summed over ``pipe``, on every rank."""
        from .pipe.schedule import fill_drain
        stacked = {k: v[None] for k, v in self._place(batch).items()}
        if self._sp > 1:
            stacked = self._seq_split(stacked)
        stage = self._pipe_stage(stacked, train=False)
        fill_drain(stage, 1, self._pipe_like(stacked))
        return dist.all_reduce(stage.loss(), group=(dist.PIPE_AXIS, dist.SEQ_AXIS))

    # ------------------------------------------------------------------ data placement
    def _place(self, batch, lead=None):
        """Host or device leaves -> tensors on the device (integer leaves as
        int64), each reshaped to ``lead + rest`` when ``lead`` is given.
        With telemetry on, the placement is tracked as ``host_to_device``
        (the JAX engine's ``engine.py:1113``)."""
        t0 = time.perf_counter()
        out = {}
        for k, x in batch.items():
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.long()
            if lead is not None:
                t = t.reshape(lead + tuple(t.shape[1:]))
            out[k] = t.to(self.device)
        if self.telemetry.enabled:
            get_overlap_tracker().track_async("host_to_device", out, t0=t0)
        return out

    def _my_rows(self, x, lead):
        """This rank's rows of a global batch leaf viewed as ``lead`` =
        (gas, dp, micro) + rest: (gas * micro) + rest."""
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        gas, dp, micro = lead
        mine = x.reshape(lead + tuple(x.shape[1:]))[:, self._dp_rank]
        return mine.reshape((gas * micro, ) + tuple(x.shape[1:]))

    def _next_microbatches(self, data_iter, n):
        batches = []
        for _ in range(n):
            batch = next(data_iter)
            if self.collate_fn is not None:
                batch = self.collate_fn(batch)
            batches.append(batch)
        return batches

    # ------------------------------------------------------------------ public API
    def train_batch(self, data_iter=None, batch=None):
        """One full training step (gas microbatches, then the optimizer
        update). Returns the mean loss (a 0-d tensor on the device).

        Pass either ``data_iter`` (pulls ``gradient_accumulation_steps``
        microbatches) or a ``batch`` dict whose leaves carry the whole train
        batch (``train_batch_size`` rows)."""
        gas = self.gradient_accumulation_steps()
        micro = self.train_micro_batch_size_per_gpu()
        if self.param_stream is not None:
            return self._param_stream_train_batch(data_iter, batch, gas)
        if batch is not None:
            leading = {int(np.shape(x)[0]) for x in batch.values()}
            share = self.train_batch_size() // self._dp
            if leading == {self.train_batch_size()}:  # the global batch: this rank's rows
                batch = {k: self._my_rows(x, (gas, self._dp, micro)) for k, x in batch.items()}
            elif leading != {share}:
                raise ValueError(
                    f"train_batch(batch=...) leaves have leading dim {sorted(leading)}; expected "
                    f"{self.train_batch_size()} samples (train_batch {self.train_batch_size()} = "
                    f"micro {micro} x gas {gas} x dp {self._dp}) or this rank's {share}")
            stacked = self._place(batch, (gas, micro))
        else:
            if data_iter is None:
                raise _unported("training_data loaders", "ROADMAP Queue 1 #10, runtime/data_pipeline")
            mbs = self._next_microbatches(data_iter, gas)
            if self._dp > 1 and {int(np.shape(x)[0]) for x in mbs[0].values()} == {micro * self._dp}:
                mbs = [{k: self._my_rows(x, (1, self._dp, micro))[0] for k, x in mb.items()} for mb in mbs]
            stacked = self._place({k: np.stack([np.asarray(mb[k]) for mb in mbs]) for k in mbs[0]})

        t0 = time.perf_counter() if self.telemetry.enabled else None
        if t0 is not None and self._step_flops is None:
            self._step_flops = self._flops_per_step(stacked.get("input_ids"), 1)
        if self._pp > 1:
            metrics = self._pipe_train_batch(stacked, gas)
        elif self.host_opt is not None:
            metrics = self._offload_train_batch(stacked, gas)
        else:
            acc, loss_sum = None, None
            scale = self.loss_scale_state.cur_scale
            for g in range(gas):
                loss, grads = self._micro_loss_and_grads(self.master, {k: v[g] for k, v in stacked.items()},
                                                         scale, self._micro_rng(g))
                if acc is None:
                    acc, loss_sum = grads, loss.float()
                else:
                    torch._foreach_add_(acc, grads)
                    loss_sum = loss_sum + loss.float()
                del grads
            metrics = self._apply_grads(acc, loss_sum / gas)
        if t0 is not None:
            path = "pipeline" if self._pp > 1 else "offload" if self.host_opt is not None else "fused"
            self._record_step(t0, {"path": path, "micro_batches": gas})
            self._emit_comm_overlap()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.micro_steps += gas
        self._last_metrics = metrics
        self._report(metrics)
        if self.lr_scheduler is not None:
            self.lr_scheduler.last_batch_iteration = self.global_steps
        return metrics["loss"]

    def _param_stream_train_batch(self, data_iter, batch, gas):
        """One streamed step (``param_stream.train_batch``); the engine's
        counters follow the runner's (an overflow-skipped step does not
        advance it)."""
        micro = self.train_micro_batch_size_per_gpu()
        if batch is None:
            if data_iter is None:
                raise _unported("training_data loaders", "ROADMAP Queue 1 #10, runtime/data_pipeline")
            mbs = self._next_microbatches(data_iter, gas)
            if self._dp > 1 and {int(np.shape(x)[0]) for x in mbs[0].values()} == {micro * self._dp}:
                mbs = [{k: self._my_rows(x, (1, self._dp, micro))[0] for k, x in mb.items()} for mb in mbs]
            batch = {k: np.concatenate([np.asarray(mb[k]) for mb in mbs]) for k in mbs[0]}
        elif self._dp > 1 and {int(np.shape(x)[0]) for x in batch.values()} == {self.train_batch_size()}:
            batch = {k: self._my_rows(x, (gas, self._dp, micro)) for k, x in batch.items()}
        t0 = time.perf_counter() if self.telemetry.enabled else None
        if t0 is not None and self._step_flops is None:
            ids = batch.get("input_ids")
            self._step_flops = self._flops_per_step(None if ids is None else torch.as_tensor(np.asarray(ids)),
                                                    1)
        metrics = self.param_stream.train_batch(batch)
        self.global_steps = self.param_stream.global_steps
        self.step_count = self.param_stream.global_steps
        self.global_samples += self.train_batch_size()
        self.micro_steps += gas
        self._last_metrics = metrics
        if t0 is not None:
            pt = self.param_stream.last_phase_times or {}
            self._record_step(t0, {"path": "param_stream",
                                   "overlap_efficiency": round(pt.get("overlap_efficiency", 0.0), 4)})
            # realized (not dispatched) transfer overlap: the executor fences
            # every put, so issue time, completion and exposure are apart
            self.telemetry.gauges([
                ("offload/put_dispatch_ms", pt.get("put_dispatch_s", 0.0) * 1e3, self.global_samples),
                ("offload/put_realized_ms", pt.get("put_realized_s", 0.0) * 1e3, self.global_samples),
                ("offload/fetch_wait_ms", pt.get("drain_s", 0.0) * 1e3, self.global_samples),
                ("offload/overlap_efficiency", pt.get("overlap_efficiency", 0.0), self.global_samples),
            ])
        self._report(metrics)
        if self.lr_scheduler is not None:
            self.lr_scheduler.last_batch_iteration = self.global_steps
        return torch.tensor(metrics["loss"])

    def _refuse_facade(self):
        if self._pp > 1:
            raise RuntimeError("the forward/backward/step facade is not supported under pipeline parallelism; use "
                               "train_batch() (the reference PipelineEngine likewise only supports train_batch, "
                               "pipe/engine.py:285)")
        if self.host_opt is not None or self.param_stream is not None:
            raise RuntimeError("the forward/backward/step facade is not supported with "
                               "offload_optimizer/offload_param; use train_batch()")

    def forward(self, batch):
        """Facade: one microbatch's loss and gradients, accumulated until
        :meth:`step` (reference engine.py:1624; forward and backward fuse
        here as in the JAX engine, so ``backward`` only marks the
        micro-step)."""
        self._refuse_facade()
        placed = self._place(batch)
        if self.telemetry.enabled and self._step_flops is None:
            self._step_flops = self._flops_per_step(placed.get("input_ids"),
                                                    self.gradient_accumulation_steps())
        t0 = time.perf_counter() if self.telemetry.enabled else None
        loss, grads = self._micro_loss_and_grads(self.master, placed, self.loss_scale_state.cur_scale,
                                                 self._micro_rng(self._micro_step))
        if t0 is not None:
            self._sync()
            dur = time.perf_counter() - t0
            self.telemetry.record_span("fwd", self.telemetry.now() - dur, dur)
            if self._micro_step == 0:  # the step's first micro-batch starts its span
                self._facade_t0 = t0
        if self._grad_acc is None:
            self._grad_acc = grads
        else:
            torch._foreach_add_(self._grad_acc, grads)
        self._micro_step += 1
        self._pending_losses.append(loss)
        return loss

    def backward(self, loss=None, allreduce_gradients=True, retain_graph=False):
        """Facade: gradients were produced in forward(); this marks the
        micro-step boundary (reference engine.py:1765)."""
        self._refuse_facade()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self._micro_step % self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None):
        """Facade: apply the accumulated gradients at a boundary (reference
        engine.py:1961)."""
        self._refuse_facade()
        gas = self.gradient_accumulation_steps()
        if self._micro_step < gas:
            return None
        loss_mean = torch.stack([p.float() for p in self._pending_losses[-gas:]]).mean()
        metrics = self._apply_grads(self._grad_acc, loss_mean)
        if self.telemetry.enabled:
            self._record_step(self._facade_t0, {"path": "facade", "micro_batches": gas})
            self._emit_comm_overlap()
        self._grad_acc, self._micro_step, self._pending_losses = None, 0, []
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._last_metrics = metrics
        self._report(metrics)
        if self.lr_scheduler is not None:
            self.lr_scheduler.last_batch_iteration = self.global_steps
        return metrics

    @torch.no_grad()
    def eval_batch(self, batch):
        if self._pp > 1:
            return self._pipe_eval(batch)
        if self.param_stream is not None:
            return torch.tensor(self.param_stream.eval_batch(batch)["loss"])
        p_c = {k: v.to(self.compute_dtype) for k, v in self.master.items()}
        if self.host_opt is None and self._sharded:
            p_c = {k: unshard(v, self._specs["master"][k]) for k, v in p_c.items()}
        if self._sp == 1:
            return self.loss_fn(p_c, self._place(batch))
        # this rank's chunk, over the sequence's valid count, summed over seq
        placed = self._seq_split(self._place(batch))
        n_valid = torch.clamp(dist.all_reduce((placed["labels"] >= 0).sum(), group=dist.SEQ_AXIS), min=1)
        return dist.all_reduce(self.loss_fn(p_c, placed, n_valid=n_valid), group=dist.SEQ_AXIS)

    def __call__(self, batch):
        return self.eval_batch(batch)

    def zero_grad(self):
        self._grad_acc, self._micro_step, self._pending_losses = None, 0, []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _flops_per_step(self, ids, repeats):
        """``bench.py::_mfu``'s count, 6 N_nonemb + 12 L H T FLOPs a token,
        times the tokens of ``repeats`` batches of ``ids`` (the step's input
        ids); None for a model without a config or a batch without
        ``input_ids`` (the MFU gauge is then not emitted)."""
        cfg = getattr(self.module, "cfg", None)
        if cfg is None or ids is None or not hasattr(cfg, "num_params"):
            return None
        seq = int(ids.shape[-1])
        n_emb = cfg.vocab_size * cfg.hidden_size + (cfg.max_seq_len * cfg.hidden_size
                                                    if cfg.pos_embedding == "learned" else 0)
        per_token = 6 * (cfg.num_params() - n_emb) + 12 * cfg.num_layers * cfg.hidden_size * seq
        return float(per_token * ids.numel() * repeats)

    def _record_step(self, t0, attrs):
        """The step span, timed to a device synchronize."""
        self._sync()
        dur = time.perf_counter() - t0
        self._last_step_dur = dur
        self.telemetry.record_span("step", self.telemetry.now() - dur, dur, attrs=attrs)

    def _emit_comm_overlap(self):
        """Drain the step's comm accounting (``comm/overlap.py``: the batch
        placement, stage 3's block gathers, the control-plane ops) into
        ``comm/{op}/realized_ms``, ``comm/{op}/dispatch_ms`` and
        ``comm/overlap_efficiency`` gauges (the JAX engine's
        ``engine.py:1503-1525``); after :meth:`_record_step`'s synchronize,
        so stage 3's stall events have completed."""
        gatherer = self._stage3.gatherer if self._stage3 is not None else self._pipe_gatherer
        if gatherer is not None:
            gatherer.settle()
        stats = get_overlap_tracker().collect(reset=True)
        if not stats["ops"]:
            return
        gauges = []
        for op, st in sorted(stats["ops"].items()):
            gauges.append((f"comm/{op}/realized_ms", st["realized_s"] * 1e3, self.global_samples))
            gauges.append((f"comm/{op}/dispatch_ms", st["dispatch_s"] * 1e3, self.global_samples))
        gauges.append(("comm/overlap_efficiency", stats["overlap_efficiency"], self.global_samples))
        self.telemetry.gauges(gauges)
        self.last_comm_overlap = stats

    def _interval_gauges(self):
        """Throughput, MFU and device/host memory watermark gauges for one
        report interval, as (name, value, step) tuples on the ``global_samples``
        axis (the Train/Samples scalars' axis)."""
        out = []
        if self._last_step_dur:
            out.append(("throughput/samples_per_sec", self.train_batch_size() / self._last_step_dur,
                        self.global_samples))
        if self._step_flops and self._last_step_dur:
            peak = get_accelerator().peak_flops(self.compute_dtype)
            out.append(("mfu", self._step_flops / self._last_step_dur / peak, self.global_samples))
        if self.device.type == "cuda":
            out.append(("memory/device_bytes_in_use", torch.cuda.memory_allocated(self.device),
                        self.global_samples))
            out.append(("memory/device_peak_bytes", torch.cuda.max_memory_allocated(self.device),
                        self.global_samples))
        try:
            import psutil
        except ImportError:
            return out
        out.append(("memory/host_rss_bytes", psutil.Process().memory_info().rss, self.global_samples))
        return out

    def _report(self, metrics):
        if self.global_steps % self.steps_per_print() == 0:
            loss, lr = float(metrics["loss"]), float(metrics["lr"])
            msg = (f"step={self.global_steps} loss={loss:.4f} "
                   f"lr={lr:.3e} grad_norm={metrics['grad_norm']:.3f}")
            if self.fp16_enabled():
                msg += f" loss_scale={metrics['loss_scale']:g}"
            log_dist(msg, [0])
            # one batched sink call per interval: the monitor backends get
            # one write_events, the JSONL/trace the same scalars as gauges
            tel = self.telemetry
            scalars = [("Train/Samples/train_loss", loss, self.global_samples),
                       ("Train/Samples/lr", lr, self.global_samples)]
            if self.fp16_enabled():
                scalars.append(("Train/Samples/loss_scale", float(metrics["loss_scale"]),
                                self.global_samples))
            if tel.enabled:
                scalars.append(("Train/Samples/grad_norm", float(metrics["grad_norm"]),
                                self.global_samples))
                scalars.extend(self._interval_gauges())
            tel.gauges(scalars)
            if self._slo is not None:
                self._slo.maybe_evaluate()
            if self.profiler is not None:
                # the report boundary starts a pending request_profile() and
                # reaps an overdue capture
                started = self.profiler.maybe_capture(tag="report")
                if started is not None:
                    log_dist(f"torch.profiler capture started: {started}", [0])

    def request_profile(self, duration_s=1.0):
        """Arm a duration-bounded ``torch.profiler`` capture that begins at
        the next report interval (``steps_per_print`` boundary); traces land
        under the telemetry output path, one ``torch_trace_*`` directory a
        capture. Raises without telemetry, and
        :class:`~deepspeed_tpu_torch.telemetry.profiler.ProfileBusy` while a
        capture is in flight or pending."""
        if self.profiler is None:
            raise RuntimeError("request_profile requires telemetry.enabled "
                               "(the trace needs an output path)")
        self.profiler.request(duration_s)

    # ------------------------------------------------------------------ checkpoint
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Checkpoint under ``save_dir/tag`` (default ``global_step<N>``;
        the JAX engine's ``engine.py:1658``, its non-offload path): the fp32
        master, optimizer state, loss scaler and step counts in
        ``state/``, the counters, lr schedule, config and ``client_state``
        in ``client_sd.json``. With ``checkpoint.async_save`` the file is
        written on a thread (:meth:`wait_checkpoint_saves`); the tensors are
        copied to the host before this returns either way."""
        tag = tag or f"global_step{self.global_steps}"
        client_sd = dict(client_state or {})
        client_sd.update({
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler is not None else None,
            "ds_config": self._config.raw_config,
            "world_size": self._config.world_size,
            "pipeline_parallel_size": self._pp,
        })
        # the facade's gradient accumulator is in-flight scratch, not
        # training state (reference engine.py:3012 skips its buffers too)
        master, opt_state = self._checkpoint_state()
        state = {"master": master, "optimizer": opt_state,
                 "loss_scale": self.loss_scale_state.to_dict(), "step_count": self.step_count,
                 "skipped_steps": self.skipped_steps}
        # the state holds global logical tensors, the same on every rank:
        # rank 0 alone writes, the others wait for the file
        if dist.get_rank() == 0:
            ckpt.save_checkpoint(save_dir, tag, state, client_sd, save_latest=save_latest,
                                 use_async=self._config.checkpoint.async_save)
        del state, master, opt_state
        dist.barrier()
        log_dist(f"saved checkpoint {save_dir}/{tag}", [0])
        return True

    def _checkpoint_state(self):
        """(fp32 master dict, optimizer state) as global logical tensors:
        the offload tiers write their host master and moments under the
        on-device AdamW's keys; a sharded master and its moments are
        gathered one tensor at a time (each to the host before the next)."""
        if self.param_stream is not None:
            master, mu, nu = self.param_stream.state_tensors()
            return master, {"count": self.param_stream.store.t, "mu": mu, "nu": nu}
        if self.host_opt is not None:
            master, mu, nu = self.host_opt.state_tensors()
            if self._offload_sharded:
                spec = self._specs["offload"]
                master = {k: unshard(v, spec[k]) for k, v in master.items()}
                mu = [unshard(v, spec[k]) for k, v in zip(master, mu)]
                nu = [unshard(v, spec[k]) for k, v in zip(master, nu)]
            return master, {"count": self.host_opt.t, "mu": mu, "nu": nu}
        if not self._sharded and self._tp == 1 and self._pp == 1:
            return self.master, self.optimizer.state_dict()
        if isinstance(self.optimizer, ClientOptimizer):
            raise NotImplementedError("a checkpoint of a client optimizer's state over ZeRO, tensor or pipe shards "
                                      "(its state is per rank; use a built-in optimizer) (ROADMAP Queue 1 #7.1, its "
                                      "leftover)")
        spec = self._specs["master"]

        def whole(k, t):  # over the data axes, then over tensor
            t = t.detach()
            if sharded_dims(spec[k]) or self._tp_dims.get(k) is not None:
                t = self._tp_whole(k, unshard(t, spec[k]))
            return t

        sd = self.optimizer.state_dict()
        keys = list(self.master)
        if self._pp > 1:  # every stage's layers, on stage 0, in the one-stage key order
            where = {k: i for i, k in enumerate(keys)}
            opt = {name: list(self._pipe_tensors(lambda k, v=val: whole(k, v[where[k]]), torch.float32).values())
                   if isinstance(val, list) and len(val) == len(keys) else val for name, val in sd.items()}
            return self._pipe_tensors(lambda k: whole(k, self.master[k]), torch.float32), opt
        opt = {name: [whole(k, t).cpu() for k, t in zip(keys, val)] if isinstance(val, list) and len(val) == len(keys)
               else val for name, val in sd.items()}
        return {k: whole(k, v).cpu() for k, v in self.master.items()}, opt

    def _pipe_tensors(self, local, dtype):
        """{key: whole host tensor} of every model tensor in the model's key
        order on pipe stage 0 (on another stage: of the keys it holds).
        ``local(k)``: this rank's ``dtype`` tensor of a key it holds, whole
        over the data and tensor axes. A layer of another stage comes to
        stage 0 over ``pipe``."""
        out = {}
        for k in self._all_keys:
            owner = self.planner.pipe_stage(k)
            t = local(k) if k in self.master else None
            if owner is not None and owner != 0:
                t = self._from_stage(t, owner, dtype)
            if t is not None:
                out[k] = t.cpu()
        return out

    def _from_stage(self, t, owner, dtype):
        """Stage ``owner``'s ``t`` on stage 0, None elsewhere (every member
        of the pipe group calls it): its shape, then its values, each a
        ``ppermute`` from ``owner`` to 0."""
        meta = torch.zeros(8, dtype=torch.int64, device=self.device)
        if t is not None:
            meta[0] = t.dim()
            meta[1:1 + t.dim()] = torch.tensor(t.shape)
        meta = dist.ppermute(meta, [(owner, 0)], dist.PIPE_AXIS)
        if self._stage == 0:
            buf = torch.empty(tuple(meta[1:1 + int(meta[0])].tolist()), dtype=dtype, device=self.device)
        else:
            buf = t.contiguous() if t is not None else torch.empty(0, dtype=dtype, device=self.device)
        got = dist.ppermute(buf, [(owner, 0)], dist.PIPE_AXIS)
        return got if self._stage == 0 else None

    def wait_checkpoint_saves(self):
        """Block until an in-flight async checkpoint is written and its
        'latest' pointer moved."""
        ckpt.wait_pending_saves()

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False, custom_load_fn=None):
        """Load a :meth:`save_checkpoint` checkpoint (``tag`` None: the one
        ``latest`` names). Returns ``(load_dir, client_sd)``, or ``(None,
        None)`` when there is none. The master and the applied-step count
        always load; the optimizer state, loss scaler and skipped-step count
        unless ``load_optimizer_states`` is False or ``load_module_only``;
        the lr schedule's state with ``load_lr_scheduler_states``.
        ``load_module_strict`` False loads the master tensors both sides
        have. The facade's accumulated gradients are dropped."""
        offloaded = self.host_opt is not None or self.param_stream is not None
        ckpt.wait_pending_saves()
        dist.barrier()  # rank 0's write is in place
        state, client_sd = ckpt.load_checkpoint(load_dir, tag,
                                                map_location="cpu" if offloaded or self._sharded or self._tp > 1
                                                or self._pp > 1 else self.device)
        if state is None:
            return None, None
        saved_world = client_sd.get("world_size", 1)
        if saved_world != self._config.world_size and \
                saved_world // client_sd.get("pipeline_parallel_size", 1) != self._config.world_size // self._pp:
            raise _unported(f"a resume at world size {self._config.world_size} of a checkpoint saved at "
                            f"{client_sd['world_size']}", "ROADMAP Queue 1 #9, elastic controller")
        with_opt = load_optimizer_states and not load_module_only
        if offloaded:
            self._load_offloaded(state, with_opt)
        else:
            self._load_master(state["master"], load_module_strict)
        self.step_count = int(state["step_count"])
        if self.param_stream is not None:
            self.param_stream.global_steps = self.step_count
        if with_opt and offloaded:
            self.loss_scale_state = LossScaleState.from_dict(state["loss_scale"])
            self.skipped_steps = int(state["skipped_steps"])
        elif with_opt:
            self.optimizer.load_state_dict(self._shard_state(self._in_master_order(state)))
            self.loss_scale_state = LossScaleState.from_dict(state["loss_scale"])
            self.skipped_steps = int(state["skipped_steps"])
        self.zero_grad()
        self.global_steps = client_sd.get("global_steps", self.step_count)
        self.global_samples = client_sd.get("global_samples", 0)
        self.micro_steps = client_sd.get("micro_steps", 0)
        if load_lr_scheduler_states and self.lr_scheduler is not None and client_sd.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(client_sd["lr_scheduler"])
        self.loaded_checkpoint_tag = tag
        return load_dir, client_sd

    def _in_master_order(self, state):
        """The saved optimizer state with its per-tensor lists in this
        engine's master order (a checkpoint of an offload tier lists them in
        the model's state-dict order; a pipe stage takes its keys' only)."""
        saved, mine = list(state["master"]), list(self.master)
        sd = state["optimizer"]
        if saved == mine or not set(mine) <= set(saved):
            return sd
        where = {k: i for i, k in enumerate(saved)}
        return {name: [val[where[k]] for k in mine] if isinstance(val, list) and len(val) == len(saved) else val
                for name, val in sd.items()}

    def _load_offloaded(self, state, with_opt):
        """Restore an offload tier from a checkpoint of any tier: the master,
        and with ``with_opt`` the moments when the saved optimizer is an
        AdamW state (else fresh moments, as without ``with_opt``)."""
        opt = state.get("optimizer") or {}
        has_moments = with_opt and "mu" in opt and "nu" in opt
        keys = list(state["master"])  # the lists follow the saved master's order
        mu, nu = (dict(zip(keys, opt["mu"])), dict(zip(keys, opt["nu"]))) if has_moments else (None, None)
        count = int(opt.get("count", state["step_count"])) if has_moments else 0
        if with_opt and not has_moments:
            logger.warning("offload: the checkpoint carries no Adam moments; the master loads, the "
                           "moments start at zero")
        master = state["master"]
        if self._offload_sharded:  # this rank's partitions
            spec = self._specs["offload"]
            master = {k: shard(v, spec[k]) for k, v in master.items()}
            mu, nu = ({k: shard(v, spec[k]) for k, v in x.items()} if x is not None else None for x in (mu, nu))
        target = self.param_stream if self.param_stream is not None else self.host_opt
        target.load_state(master, mu, nu, count)
        if self._offload_sharded:
            self._offload_gather()

    def _shard_state(self, sd):
        """An optimizer state of global logical tensors (lists in master
        order) cut to this rank's shards."""
        if not self._sharded and self._tp == 1:
            return sd
        keys, spec = list(self.master), self._specs["master"]
        return {name: [shard(self._tp_slice(k, t), spec[k]) for k, t in zip(keys, val)]
                if isinstance(val, list) and len(val) == len(keys) else val for name, val in sd.items()}

    @torch.no_grad()
    def _load_master(self, saved, strict):
        want = set(self._all_keys) if self._pp > 1 else set(self.master)
        if strict and set(saved) != want:
            missing, extra = sorted(want - set(saved)), sorted(set(saved) - want)
            raise RuntimeError(f"checkpoint master does not match the model: missing {missing[:5]}, "
                               f"unexpected {extra[:5]}")
        for k, v in saved.items():
            if k in self.master:
                self.master[k].copy_(shard(self._tp_slice(k, v), self._specs["master"][k]))

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin", exclude_frozen_parameters=False):
        """The master cast to the compute dtype, as a state dict written by
        ``torch.save`` under the reference DeepSpeed file name (the JAX
        engine writes a flax msgpack instead). Returns the path."""
        path = os.path.join(save_dir, save_filename)
        if self.param_stream is not None or self.host_opt is not None:
            master = self._checkpoint_state()[0]
            sd = {k: v.detach().to(self.compute_dtype).cpu() for k, v in master.items()}
        else:  # one tensor at a time: cast, gather, to the host
            spec = self._specs["master"]

            def whole(k):
                return self._tp_whole(k, unshard(self.master[k].detach().to(self.compute_dtype), spec[k]))

            if self._pp > 1:
                sd = self._pipe_tensors(whole, self.compute_dtype)
            else:
                sd = {k: whole(k).cpu() for k in self.master}
        if dist.get_rank() == 0:
            os.makedirs(save_dir, exist_ok=True)
            torch.save(sd, path)
        dist.barrier()
        return path

    # ------------------------------------------------------------------ not ported yet
    def deepspeed_io(self, *args, **kwargs):
        raise _unported("deepspeed_io", "ROADMAP Queue 1 #10, runtime/data_pipeline")
