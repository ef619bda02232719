from .checkpoint import CheckpointManager, load_params, save_params
from .engine import (
    AverageMeter,
    evaluate,
    evaluate_md17,
    make_dens_steps,
    make_md17_steps,
    make_qm9_steps,
    masked_mean,
)
from .optim import (
    OPTIMIZERS,
    AdamW,
    cosine_warmup_schedule,
    create_optimizer,
    ema_update,
    multistep_warmup_schedule,
    no_weight_decay_mask,
)
from .state import TrainState
