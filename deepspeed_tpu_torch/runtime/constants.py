"""Config key names.

Port of ``deepspeed_tpu/runtime/constants.py`` (itself a condensed analogue
of the reference ``deepspeed/runtime/constants.py``). Key *names* match the
reference so user configs are drop-in. Defaults live in ONE place — the
``ConfigField`` declarations in ``config.py`` — not here.
"""

#############################################
# Batch size and accumulation
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

#############################################
# Optimizer / scheduler sections
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

# Supported optimizer names (reference engine.py ADAM_OPTIMIZER etc.)
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
ADAGRAD_OPTIMIZER = "adagrad"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER, ADAGRAD_OPTIMIZER, LAMB_OPTIMIZER,
    ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER
]

#############################################
# Precision / gradients
#############################################
FP32_ALLREDUCE = "fp32_allreduce"
PREC_SCALE = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
SPARSE_GRADIENTS = "sparse_gradients"
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_AUTO_CAST = "auto_cast"
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_HYSTERESIS = "hysteresis"
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # deprecated alias kept by the reference
BFLOAT16_ENABLED = "enabled"
AMP = "amp"
AMP_ENABLED = "enabled"
GRADIENT_CLIPPING = "gradient_clipping"
COMMUNICATION_DATA_TYPE = "communication_data_type"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"

#############################################
# Sections
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
STEPS_PER_PRINT = "steps_per_print"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
DUMP_STATE = "dump_state"
MEMORY_BREAKDOWN = "memory_breakdown"
TENSORBOARD = "tensorboard"
CSV_MONITOR = "csv_monitor"
WANDB = "wandb"
MONITOR_ENABLED = "enabled"
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
DATA_TYPES = "data_types"
DATALOADER_DROP_LAST = "dataloader_drop_last"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
PLD = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_THETA = "theta"
PLD_GAMMA = "gamma"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
DATA_EFFICIENCY = "data_efficiency"
ELASTICITY = "elasticity"
COMPRESSION_TRAINING = "compression_training"
FLOPS_PROFILER = "flops_profiler"
AUTOTUNING = "autotuning"
COMMS_LOGGER = "comms_logger"

#############################################
# Parallelism axes (the JAX package's mesh section; extension over the
# reference, which delegates TP to a user mpu and has no SP)
#############################################
MESH = "mesh"
TENSOR_PARALLEL_SIZE = "tensor_parallel_size"
PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"
