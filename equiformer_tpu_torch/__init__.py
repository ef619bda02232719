"""PyTorch + CUDA port of ``equiformer_tpu`` (imports torch and numpy, never jax).

Module paths mirror the JAX package.  Features keep its component-major
[2l+1, mul] block layout, so every activation compares with the reference
element by element.  The kernels of the QM9 training and inference path are
hand-written CUDA for Hopper (``csrc/``), each beside its plain PyTorch
version (``kernels/``).
"""

from . import core, data, graph, kernels, models, nn, train, utils  # noqa: F401
from .models import model_entrypoint
from .train import (
    TrainState,
    cosine_warmup_schedule,
    create_optimizer,
    evaluate,
    make_qm9_steps,
)
