from .equiformer import (
    FeedForwardNetwork,
    GraphAttention,
    GraphAttentionTransformer,
    TransBlock,
)
from .registry import model_entrypoint, register_model
from . import dens, md17_models, qm9_models  # noqa: F401  (register the entrypoints)
from .dens import EquiformerDeNS, add_masked_gaussian_noise, dens_outputs
from .md17_models import energy_and_forces
