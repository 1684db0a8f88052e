from .module import LayerSpec, TiedLayerSpec, PipelineModule, partition_balanced, partition_uniform  # noqa: F401
from .schedule import (PipeStage, fill_drain, num_pipeline_steps, one_f_one_b, spmd_pipeline,  # noqa: F401
                       spmd_pipeline_1f1b)
