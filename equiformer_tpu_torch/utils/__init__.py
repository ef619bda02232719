from .convert_jax import (
    ema_from_jax,
    flax_paths,
    load_jax_tree,
    params_from_jax,
    params_to_jax,
    torch_name,
)
from .profiling import StepTimer, trace
