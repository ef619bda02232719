from .equiformer import (
    FeedForwardNetwork,
    GraphAttention,
    GraphAttentionTransformer,
    TransBlock,
)
from .registry import model_entrypoint, register_model
from . import qm9_models  # noqa: F401  (registers the entrypoints)
