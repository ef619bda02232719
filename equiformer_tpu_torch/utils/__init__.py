from .config import apply_overrides, build_config, load_config
from .convert_jax import (
    ema_from_jax,
    flax_paths,
    load_jax_tree,
    params_from_jax,
    params_to_jax,
    torch_name,
)
from .logger import FileLogger, MetricsWriter
from .profiling import StepTimer, trace
from .seeding import set_seed
