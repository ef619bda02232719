"""Console and file logger, and the metric sinks.

Counterpart of ``equiformer_tpu.utils.logger``: ``FileLogger`` (the
reference's rank-0 logger; other ranks get a no-op sink), ``MetricsWriter``
(one JSON line a logged step) and ``WandBLogger``, which
``train/registry.py`` names "file", "jsonl" and "wandb".
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


class FileLogger:
    """Lines ``<time> - <message>`` to stdout and, with ``output_dir``, to
    ``output_dir/debug.log``."""

    def __init__(self, is_master: bool = True, output_dir: Optional[str] = None,
                 name: str = "equiformer_tpu_torch"):
        self.is_master = is_master
        self._logger = None
        if is_master:
            logger = logging.getLogger(name)
            logger.setLevel(logging.INFO)
            logger.propagate = False
            for h in list(logger.handlers):
                logger.removeHandler(h)
                h.close()
            fmt = logging.Formatter("%(asctime)s - %(message)s")
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(fmt)
            logger.addHandler(sh)
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                fh = logging.FileHandler(os.path.join(output_dir, "debug.log"))
                fh.setFormatter(fmt)
                logger.addHandler(fh)
            self._logger = logger

    def info(self, msg, *args):
        if self._logger:
            self._logger.info(msg, *args)

    def warning(self, msg, *args):
        if self._logger:
            self._logger.warning(msg, *args)


class MetricsWriter:
    """``output_dir/metrics.jsonl``: one JSON object a logged step."""

    def __init__(self, output_dir: Optional[str], is_master: bool = True):
        self._fh = None
        if is_master and output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict, prefix: str = ""):
        if self._fh is None:
            return
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            rec[(prefix + "/" + k) if prefix else k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class WandBLogger:
    """Weights & Biases sink.  ``wandb`` is imported only here, when the
    logger is built; without the package it warns and does nothing."""

    def __init__(self, output_dir: Optional[str], enabled: bool = True,
                 project: str = "equiformer-tpu", config: Optional[Dict] = None):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
        except ImportError:
            logging.getLogger("equiformer_tpu_torch").warning(
                "wandb requested but not installed; metrics logging disabled")
            return
        self._run = wandb.init(project=project, dir=output_dir, config=config)

    def add_scalars(self, step: int, scalars: Dict, prefix: str = ""):
        if self._run is None:
            return
        self._run.log({(prefix + "/" + k) if prefix else k: float(v)
                       for k, v in scalars.items()}, step=step)

    def close(self):
        if self._run is not None:
            self._run.finish()
