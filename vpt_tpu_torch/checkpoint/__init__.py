from vpt_tpu_torch.checkpoint.torch_import import (
    from_jax_variables,
    load_model_parameters,
    load_state_dict_report,
    load_weights,
    save_model_parameters,
    save_weights,
)

__all__ = [
    "from_jax_variables",
    "load_model_parameters",
    "load_state_dict_report",
    "load_weights",
    "save_model_parameters",
    "save_weights",
]
