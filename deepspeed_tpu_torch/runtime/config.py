"""Top-level config.

Port of ``deepspeed_tpu/runtime/config.py`` (analogue of the reference
``deepspeed/runtime/config.py``: ``DeepSpeedConfig`` :674, batch-size triple
resolution :738-760). Accepts the same JSON document (path or dict), parses
every section with the same keys and the same errors, and resolves the
batch triple over the live ``torch.distributed`` world (``comm``; world
size 1 without one), the data-parallel degree spanning expert x data as
in the JAX package.

Sections the port's engine does not run yet raise ``NotImplementedError``
naming their ROADMAP item when present and not disabled (an empty section,
or one with ``"enabled": false``, is accepted); sections the JAX package
itself leaves inert warn as it does.
"""

import json
import os

import torch

from .config_utils import DeepSpeedConfigModel, ConfigField, dict_raise_error_on_duplicate_keys
from .zero.config import DeepSpeedZeroConfig
from ..utils.logging import logger


class FP16Config(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)
    auto_cast = ConfigField(default=False)
    loss_scale = ConfigField(default=0)
    initial_scale_power = ConfigField(default=16)
    loss_scale_window = ConfigField(default=1000)
    hysteresis = ConfigField(default=2)
    min_loss_scale = ConfigField(default=1)
    fp16_master_weights_and_grads = ConfigField(default=False)
    fp16_opt_level = ConfigField(default=None)  # accepted, unused (apex-ism)


class BF16Config(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)


class OptimizerConfig(DeepSpeedConfigModel):
    type = ConfigField(default=None)
    params = ConfigField(default=dict)
    legacy_fusion = ConfigField(default=False)


class SchedulerConfig(DeepSpeedConfigModel):
    type = ConfigField(default=None)
    params = ConfigField(default=dict)


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """Reference ``runtime/activation_checkpointing/config.py`` keys."""
    partition_activations = ConfigField(default=False)
    contiguous_memory_optimization = ConfigField(default=False)
    cpu_checkpointing = ConfigField(default=False)
    number_checkpoints = ConfigField(default=None)
    synchronize_checkpoint_boundary = ConfigField(default=False)
    profile = ConfigField(default=False)
    # the JAX package's remat policy name (e.g. "dots_saveable")
    policy = ConfigField(default=None)


class MonitorBackendConfig(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)
    output_path = ConfigField(default="")
    job_name = ConfigField(default="DeepSpeedJobName")
    # wandb-only
    team = ConfigField(default=None)
    group = ConfigField(default=None)
    project = ConfigField(default=None)


class CommsLoggerConfig(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)
    verbose = ConfigField(default=False)
    prof_all = ConfigField(default=True)
    debug = ConfigField(default=False)
    prof_ops = ConfigField(default=list)


class FlopsProfilerConfig(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)
    recompute_fwd_factor = ConfigField(default=0.0)
    profile_step = ConfigField(default=1)
    module_depth = ConfigField(default=-1)
    top_modules = ConfigField(default=1)
    detailed = ConfigField(default=True)
    output_file = ConfigField(default=None)


class TelemetryConfig(DeepSpeedConfigModel):
    """The JAX package's telemetry section (same keys): the engine's
    ``telemetry.TelemetrySink``, its SLO engine and profiler."""
    enabled = ConfigField(default=False)
    output_path = ConfigField(default="telemetry")
    flush_interval = ConfigField(default=100)
    trace_format = ConfigField(default="chrome")
    hist_window_s = ConfigField(default=300.0)
    hist_max_samples = ConfigField(default=4096)
    request_tracing = ConfigField(default=True)
    flight_recorder = ConfigField(default=dict)
    slo = ConfigField(default=dict)
    capacity_sample_every = ConfigField(default=32)
    profile_report_s = ConfigField(default=0.0)


class CheckpointConfig(DeepSpeedConfigModel):
    """``async_save``: the file is written on a thread (the engine's
    ``save_checkpoint``)."""
    tag_validation = ConfigField(default="Warn")
    load_universal = ConfigField(default=False)
    use_node_local_storage = ConfigField(default=False)
    parallel_write = ConfigField(default=dict)
    async_save = ConfigField(default=False)


class MeshConfig(DeepSpeedConfigModel):
    """The JAX package's parallel axis sizes (same keys): pipe, expert,
    data, seq and tensor, whose product is the world size."""
    tensor_parallel_size = ConfigField(default=1, aliases=("model_parallel_size",))
    pipeline_parallel_size = ConfigField(default=1)
    sequence_parallel_size = ConfigField(default=1)
    expert_parallel_size = ConfigField(default=1)
    data_parallel_size = ConfigField(default=None)  # inferred if None
    axis_order = ConfigField(default=("pipe", "data", "seq", "tensor"))


class DeepSpeedConfigError(Exception):
    pass


# sections present and enabled that the port's engine does not run yet
_UNPORTED_SECTIONS = {
    "curriculum_learning": "ROADMAP Queue 1 #10, runtime/data_pipeline",
    "progressive_layer_drop": "ROADMAP Queue 1 #10, runtime/data_pipeline",
    "data_efficiency": "ROADMAP Queue 1 #10, runtime/data_pipeline",
    "hybrid_engine": "ROADMAP Queue 1 #9, RLHF",
    "eigenvalue": "ROADMAP Queue 1 #10, compression",
    "compression_training": "ROADMAP Queue 1 #10, compression",
    "flops_profiler": "ROADMAP Queue 1 #10, profiling",
    "elasticity": "ROADMAP Queue 1 #9, elastic controller",
    "nebula": "ROADMAP Queue 1 #10, checkpoint",
}


def _section_on(val):
    """A config section that asks for something: not empty, not false and
    not ``{"enabled": false, ...}``."""
    if val in (False, None) or val == {} or val == []:
        return False
    return not (isinstance(val, dict) and val.get("enabled", True) is False)


class DeepSpeedConfig(DeepSpeedConfigModel):
    _allow_extra = True  # top level tolerates sections consumed elsewhere

    train_batch_size = ConfigField(default=None)
    train_micro_batch_size_per_gpu = ConfigField(default=None)
    gradient_accumulation_steps = ConfigField(default=None)
    steps_per_print = ConfigField(default=10)
    dump_state = ConfigField(default=False)
    disable_allgather = ConfigField(default=False)
    communication_data_type = ConfigField(default=None)
    prescale_gradients = ConfigField(default=False)
    gradient_predivide_factor = ConfigField(default=1.0)
    sparse_gradients = ConfigField(default=False)
    gradient_clipping = ConfigField(default=0.0)
    fp32_allreduce = ConfigField(default=False)
    seed = ConfigField(default=1234)

    optimizer = ConfigField(default=OptimizerConfig)
    scheduler = ConfigField(default=SchedulerConfig)
    fp16 = ConfigField(default=FP16Config)
    bf16 = ConfigField(default=BF16Config, aliases=("bfloat16",))
    amp = ConfigField(default=dict)
    zero_optimization = ConfigField(default=DeepSpeedZeroConfig)
    activation_checkpointing = ConfigField(default=ActivationCheckpointingConfig)
    # HF-style boolean alias; folded into activation_checkpointing in __init__
    gradient_checkpointing = ConfigField(default=None)

    tensorboard = ConfigField(default=MonitorBackendConfig)
    csv_monitor = ConfigField(default=MonitorBackendConfig)
    wandb = ConfigField(default=MonitorBackendConfig)
    comms_logger = ConfigField(default=CommsLoggerConfig)
    telemetry = ConfigField(default=TelemetryConfig)
    flops_profiler = ConfigField(default=FlopsProfilerConfig)

    wall_clock_breakdown = ConfigField(default=False)
    memory_breakdown = ConfigField(default=False)
    dataloader_drop_last = ConfigField(default=False)
    data_types = ConfigField(default=dict)
    checkpoint = ConfigField(default=CheckpointConfig)
    hybrid_engine = ConfigField(default=dict)
    elasticity = ConfigField(default=dict)
    autotuning = ConfigField(default=dict)
    compression_training = ConfigField(default=dict)
    data_efficiency = ConfigField(default=dict)
    curriculum_learning = ConfigField(default=dict)
    progressive_layer_drop = ConfigField(default=dict)
    sparse_attention = ConfigField(default=dict)
    aio = ConfigField(default=dict)
    mesh = ConfigField(default=MeshConfig)
    pipeline = ConfigField(default=dict)
    zero_allow_untested_optimizer = ConfigField(default=True)
    zero_force_ds_cpu_optimizer = ConfigField(default=False)

    def __init__(self, config, mpu=None, world_size=None):
        if isinstance(config, (str, os.PathLike)):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Config file {config} not found")
            with open(config, "r") as f:
                config_dict = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            config_dict = config
        elif config is None:
            config_dict = {}
        else:
            raise DeepSpeedConfigError(f"Expected a config path or dict, got {type(config)}")

        super().__init__(config_dict)
        self.raw_config = config_dict
        self._warn_inert_sections(config_dict)
        if world_size is None:
            from .. import comm as dist
            world_size = dist.get_world_size()
        self.world_size = world_size
        self.mpu = mpu
        if mpu is not None and self.mesh.data_parallel_size is None:
            # the JAX package's rule (runtime/config.py:239-246): an mpu reports
            # the combined expert x data group; the data axis leaves out expert
            mpu_dp = mpu.get_data_parallel_world_size()
            if mpu_dp % self.mesh.expert_parallel_size == 0:
                self.mesh.data_parallel_size = mpu_dp // self.mesh.expert_parallel_size
        if self.gradient_checkpointing is not None:
            if self.gradient_checkpointing and self.activation_checkpointing.policy is None:
                self.activation_checkpointing.policy = "nothing_saveable"
        self._reject_unported(config_dict)
        self._resolve_data_parallel_size()
        self._configure_train_batch_size()
        self._do_sanity_check()

    # Sections parsed for DeepSpeed-JSON compatibility that the JAX package
    # leaves without effect either: their presence warns, as there.
    INERT_SECTIONS = frozenset({
        "amp", "sparse_attention", "sparse_gradients", "communication_data_type",
        "fp32_allreduce", "disable_allgather", "memory_breakdown", "dump_state",
        "data_types", "zero_force_ds_cpu_optimizer",
    })

    def _warn_inert_sections(self, config_dict):
        for key in sorted(set(config_dict) & self.INERT_SECTIONS):
            if _section_on(config_dict[key]):
                logger.warning(
                    f"config section '{key}' is accepted for DeepSpeed-JSON compatibility but "
                    f"has NO effect in this build — remove it or expect different behavior")

    def _reject_unported(self, config_dict):
        for key in sorted(set(config_dict) & set(_UNPORTED_SECTIONS)):
            if _section_on(config_dict[key]):
                raise NotImplementedError(f"deepspeed_tpu_torch does not support the '{key}' config "
                                          f"section yet ({_UNPORTED_SECTIONS[key]})")

    # -- batch size arithmetic (reference config.py:738-760) ---------------
    def _resolve_data_parallel_size(self):
        """The data-parallel group spans expert x data; data is what the
        world leaves after the tensor, pipe and expert axes (the JAX
        package's rule, its ``config.py:306``): the ranks of a tensor group
        and the stages of a pipe group see the same rows."""
        m = self.mesh
        non_dp = m.tensor_parallel_size * m.pipeline_parallel_size * m.sequence_parallel_size
        if self.world_size % non_dp != 0:
            raise DeepSpeedConfigError(f"world size {self.world_size} not divisible by tp*pp*sp = {non_dp}")
        if (self.world_size // non_dp) % m.expert_parallel_size != 0:
            raise DeepSpeedConfigError(f"dp group size {self.world_size // non_dp} not divisible by "
                                       f"expert_parallel_size {m.expert_parallel_size}")
        inferred_data = self.world_size // (non_dp * m.expert_parallel_size)
        if m.data_parallel_size is None:
            m.data_parallel_size = inferred_data
        elif m.data_parallel_size != inferred_data and (self.world_size > 1 or m.expert_parallel_size > 1):
            raise DeepSpeedConfigError(
                f"data_parallel_size {m.data_parallel_size} inconsistent with world size "
                f"{self.world_size} / (tp*pp*sp*ep) = {inferred_data}")

    def _configure_train_batch_size(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = self.mesh.data_parallel_size * self.mesh.expert_parallel_size

        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= dp
            grad_acc = max(1, grad_acc)
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // dp
            micro_batch //= grad_acc
            micro_batch = max(1, micro_batch)
        elif micro_batch is not None and grad_acc is not None:
            train_batch = micro_batch * grad_acc * dp
        elif train_batch is not None:
            grad_acc = 1
            micro_batch = train_batch // dp
        elif micro_batch is not None:
            train_batch = micro_batch * dp
            grad_acc = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        self.train_batch_size = train_batch
        self.train_micro_batch_size_per_gpu = micro_batch
        self.gradient_accumulation_steps = grad_acc

        if train_batch != micro_batch * grad_acc * dp:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size "
                f"{train_batch} != {micro_batch} * {grad_acc} * {dp}")

    def _do_sanity_check(self):
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.gradient_accumulation_steps < 1:
            raise DeepSpeedConfigError("gradient_accumulation_steps must be >= 1")

    # -- convenience properties mirroring engine accessors ------------------
    @property
    def zero_enabled(self):
        return self.zero_optimization.stage > 0

    @property
    def zero_stage(self):
        return self.zero_optimization.stage

    @property
    def compute_dtype(self):
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    PIPELINE_SCHEDULES = ("auto", "fill_drain", "1f1b")

    def pipeline_schedule(self):
        """The ``pipeline`` section's ``schedule`` (``auto`` by default), as
        the JAX engine reads it (``engine.py:717-726``): any other key of
        the section warns, an unknown schedule raises."""
        section = dict(self.pipeline or {})
        schedule = str(section.pop("schedule", "auto"))
        if section:
            logger.warning(f"pipeline section keys {sorted(section)} are not consumed (only 'schedule' is); "
                           f"they have NO effect in this build")
        if schedule not in self.PIPELINE_SCHEDULES:
            raise ValueError(f"pipeline.schedule must be 'auto', 'fill_drain' or '1f1b', got {schedule!r}")
        return schedule

    @property
    def loss_scale(self):
        return self.fp16.loss_scale if self.fp16.enabled else 0

    @property
    def dynamic_loss_scale(self):
        return self.fp16.enabled and self.fp16.loss_scale == 0

    def print_config(self, name="DeepSpeedConfig"):
        logger.info("{}:".format(name))
        logger.info(json.dumps(self.to_dict(), indent=2, default=str, sort_keys=True))
