"""Evaluation step for scalar-property (QM9-style) models.

``evaluate`` is the counterpart of ``eval_step`` from
``equiformer_tpu.train.engine.make_qm9_steps``: the eval-mode forward plus
the MAE sums over the real graphs of the batch.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..graph.batching import GraphsTuple


def evaluate(model: torch.nn.Module, batch: GraphsTuple, task_mean: float = 0.0,
             task_std: float = 1.0) -> Dict[str, torch.Tensor]:
    """Returns ``pred`` (normalized, [G]), ``mae_sum`` and ``count``."""
    model.eval()
    with torch.no_grad():
        pred = model(batch)
    err = pred * task_std + task_mean - batch.y.to(pred.dtype)
    gm = batch.graph_mask.to(pred.dtype)
    return {"pred": pred, "mae_sum": torch.sum(torch.abs(err) * gm), "count": torch.sum(gm)}
