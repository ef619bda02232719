from .convert_jax import params_from_jax, torch_name
