"""Per-frame eval artifacts: a CSV table always, PNG figures where
matplotlib imports.

Counterpart of ``brax_tracking_tpu/harness/eval_plots.py`` (numpy only):
each per-frame series of the eval callback's deterministic rollout (reward
terms, distances, thorax height) as one CSV column, a small-multiples
figure of them and a rollout-vs-reference thorax-height figure. The CSV is
the artifact; a figure that fails to render is logged and skipped.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Optional

import numpy as np

_logger = logging.getLogger(__name__)

# CVD-safe two-series pair (blue / orange), one hue per entity, fixed order
_ROLLOUT_COLOR = "#4269D0"
_REFERENCE_COLOR = "#E8871E"


def write_perframe_csv(path: str, series: Dict[str, np.ndarray]) -> str:
    """All per-frame series as one CSV table (column per series)."""
    keys = sorted(series)
    n = max(len(np.atleast_1d(series[k])) for k in keys)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step"] + keys)
        for i in range(n):
            row = [i]
            for k in keys:
                v = np.atleast_1d(series[k])
                row.append(float(v[i]) if i < len(v) else "")
            w.writerow(row)
    return path


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is absent."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_perframe_rewards(
    path: str, series: Dict[str, np.ndarray], title: str
) -> Optional[str]:
    """Small-multiples grid: one single-hue line subplot per series."""
    plt = _pyplot()
    keys = sorted(series)
    if plt is None or not keys:
        return None
    ncol = 3
    nrow = (len(keys) + ncol - 1) // ncol
    fig, axes = plt.subplots(
        nrow, ncol, figsize=(4.2 * ncol, 2.6 * nrow), squeeze=False
    )
    for i, k in enumerate(keys):
        ax = axes[i // ncol][i % ncol]
        v = np.atleast_1d(np.asarray(series[k], np.float64))
        ax.plot(np.arange(len(v)), v, color=_ROLLOUT_COLOR, linewidth=1.5)
        ax.set_title(k, fontsize=9)
        ax.grid(True, alpha=0.25, linewidth=0.5)
        ax.tick_params(labelsize=7)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    for j in range(len(keys), nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.suptitle(title, fontsize=11)
    fig.supxlabel("control step", fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_thorax_height(
    path: str,
    rollout_height: np.ndarray,
    reference_height: Optional[np.ndarray],
    title: str = "thorax height",
) -> Optional[str]:
    """Rollout-vs-reference thorax z trace."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8.0, 3.2))
    r = np.atleast_1d(np.asarray(rollout_height, np.float64))
    ax.plot(np.arange(len(r)), r, color=_ROLLOUT_COLOR, linewidth=1.6,
            label="rollout")
    ax.annotate("rollout", (len(r) - 1, r[-1]), color=_ROLLOUT_COLOR,
                fontsize=8, xytext=(4, 0), textcoords="offset points")
    if reference_height is not None and len(reference_height):
        q = np.atleast_1d(np.asarray(reference_height, np.float64))
        ax.plot(np.arange(len(q)), q, color=_REFERENCE_COLOR, linewidth=1.6,
                label="reference")
        ax.annotate("reference", (len(q) - 1, q[-1]), color=_REFERENCE_COLOR,
                    fontsize=8, xytext=(4, 0), textcoords="offset points")
        ax.legend(frameon=False, fontsize=8)
    ax.set_xlabel("control step", fontsize=9)
    ax.set_ylabel("height (m)", fontsize=9)
    ax.set_title(title, fontsize=11)
    ax.grid(True, alpha=0.25, linewidth=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def emit_eval_artifacts(
    fig_dir: str,
    num_steps: int,
    table: Dict[str, np.ndarray],
    distances: Dict[str, np.ndarray],
    rollout_thorax_z: np.ndarray,
    reference_thorax_z: Optional[np.ndarray],
) -> Dict[str, str]:
    """Writes the CSV and, where matplotlib renders them, the reward-curve
    and thorax-height PNGs; returns the paths written."""
    os.makedirs(fig_dir, exist_ok=True)
    series = dict(table)
    series.update(distances)
    series["thorax_height"] = rollout_thorax_z
    out: Dict[str, str] = {}
    out["perframe_csv"] = write_perframe_csv(
        os.path.join(fig_dir, f"perframe_{num_steps}.csv"), series
    )
    # the figures are optional: a plotting failure must not end a training run
    try:
        p = plot_perframe_rewards(
            os.path.join(fig_dir, f"perframe_rewards_{num_steps}.png"),
            series,
            f"per-frame eval metrics @ {num_steps} steps",
        )
        if p:
            out["perframe_rewards_png"] = p
        p = plot_thorax_height(
            os.path.join(fig_dir, f"thorax_height_{num_steps}.png"),
            rollout_thorax_z,
            reference_thorax_z,
            f"thorax height @ {num_steps} steps",
        )
        if p:
            out["thorax_height_png"] = p
    except Exception:
        _logger.warning("per-frame eval figures failed", exc_info=True)
    return out
