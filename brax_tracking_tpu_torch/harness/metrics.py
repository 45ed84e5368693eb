"""Metrics sink: JSONL always, wandb as well where it imports.

Counterpart of ``brax_tracking_tpu/harness/metrics.py``: one
``metrics.jsonl`` per run, one JSON record per ``log`` call keyed by env
steps (``_step``) with a wall-clock stamp (``_ts``), the first record the
run's config. Tensors and numpy values are written as Python numbers
(0-d) or lists.

Where wandb imports, ``wandb.init`` runs and its failure raises (the JAX
package falls back to JSONL only): log in, or set ``WANDB_MODE=offline``
or ``disabled``, or pass ``use_wandb=False``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_plain(v: Any) -> Any:
    if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
        return v.item() if v.ndim == 0 else v.tolist()
    return v


class MetricsLogger:
    """wandb-compatible ``log(metrics, step)`` facade."""

    def __init__(
        self,
        project: str,
        run_name: str,
        log_dir: str,
        config: Optional[Dict] = None,
        use_wandb: Optional[bool] = None,
    ):
        self._wandb = None
        if use_wandb is not False:
            try:
                import wandb  # type: ignore
            except ImportError:
                if use_wandb:
                    raise
            else:
                self._wandb = wandb
                wandb.init(project=project, name=run_name, config=config or {})
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self._path, "a")
        if config is not None:
            self._f.write(json.dumps({"_config": config, "_ts": time.time()}) + "\n")
            self._f.flush()

    @property
    def path(self) -> str:
        return self._path

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        plain = {k: _to_plain(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(plain, step=step)
        rec = dict(plain, _ts=time.time())
        if step is not None:
            rec["_step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        self._f.close()
