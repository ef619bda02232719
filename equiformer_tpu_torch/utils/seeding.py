"""Seeding of the host's random generators.

Counterpart of ``equiformer_tpu.utils.seeding``.  The port's device-side
randomness is explicit (a ``torch.Generator`` passed to every step), so
this seeds only what draws implicitly: Python's, numpy's and torch's
default generators.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int, deterministic: bool = True):
    """Seed every default generator.  ``deterministic`` also asks cuDNN for
    its deterministic algorithms (the port's own kernels are deterministic
    by construction)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
