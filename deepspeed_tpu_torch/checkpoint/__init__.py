from .zero_checkpoint import (get_fp32_state_dict_from_zero_checkpoint,  # noqa: F401
                              load_universal_checkpoint_params,
                              load_megatron_3d_state_dict,
                              megatron_3d_checkpoint_to_params,
                              export_reference_fp32,
                              reference_checkpoint_to_params)
