"""PyTorch + CUDA port of ``equiformer_tpu`` (imports torch and numpy, never jax).

Module paths mirror the JAX package.  Features keep its component-major
[2l+1, mul] block layout, so every activation compares with the reference
element by element.  The kernels of the QM9 training and inference path and
of the MD17 energy + force evaluation and training (DeNS too) are hand-written CUDA for Hopper
(``csrc/``), each beside its plain PyTorch version (``kernels/``).
"""

from . import core, data, graph, kernels, models, nn, train, utils  # noqa: F401
from .models import add_masked_gaussian_noise, dens_outputs, energy_and_forces, model_entrypoint
from .train import (
    CheckpointManager,
    TrainState,
    cosine_warmup_schedule,
    create_optimizer,
    evaluate,
    evaluate_md17,
    load_params,
    make_dens_steps,
    make_md17_steps,
    make_qm9_steps,
    multistep_warmup_schedule,
    save_params,
)
