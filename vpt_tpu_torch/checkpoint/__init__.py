from vpt_tpu_torch.checkpoint.torch_import import (
    cast_params,
    from_jax_variables,
    load_model_parameters,
    load_state_dict_report,
    load_weights,
    save_model_parameters,
    save_weights,
)

__all__ = [
    "cast_params",
    "from_jax_variables",
    "load_model_parameters",
    "load_state_dict_report",
    "load_weights",
    "save_model_parameters",
    "save_weights",
]
