from .engine import evaluate, make_qm9_steps, masked_mean
from .optim import AdamW, cosine_warmup_schedule, create_optimizer, ema_update, no_weight_decay_mask
from .state import TrainState
