"""Reference-clip preprocessing: mocap qpos -> tracking features.

Counterpart of ``brax_tracking_tpu/data/clips.py``: forward kinematics over
all frames of a clip, run as one batch (frames are the batch dimension),
finite-difference velocities, stac export ingestion (``load_stac_qpos``,
``clean_stac_qpos``, ``process_clip_to_train``), multi-clip stacking and
the clip cache.

The cache: ``load_clip`` reads the JAX package's pickles (``<i>.p``, a
``ReferenceClip`` of numpy arrays) through ``data.pickles`` and the port's
own ``.npz`` files; ``save_clip`` writes ``.npz`` (one array per present
field), so a JAX run never meets a cache file it cannot read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.data import pickles
from brax_tracking_tpu_torch.physics import kinematics as K
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.physics import step as pstep


@dataclasses.dataclass
class ReferenceClip:
    """Per-frame tracking targets (leading axis: frame)."""

    position: Optional[torch.Tensor] = None  # (T, 3) free-joint translation
    quaternion: Optional[torch.Tensor] = None  # (T, 4) free-joint orientation
    joints: Optional[torch.Tensor] = None  # (T, nq-7) or (T, nq) if tethered
    body_positions: Optional[torch.Tensor] = None  # (T, nbody, 3)
    body_quaternions: Optional[torch.Tensor] = None  # (T, nbody, 4)
    velocity: Optional[torch.Tensor] = None  # (T, 3)
    angular_velocity: Optional[torch.Tensor] = None  # (T, 3)
    joints_velocity: Optional[torch.Tensor] = None  # (T, nq-7)

    def replace(self, **kwargs) -> "ReferenceClip":
        return dataclasses.replace(self, **kwargs)

    def to(self, device, dtype=None) -> "ReferenceClip":
        return ReferenceClip(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
        })


def _free_root(m: M.Model) -> bool:
    return m.njnt > 0 and int(m.jnt_type[0]) == M.JNT_FREE


def extract_features(m: M.Model, mocap_qpos: torch.Tensor) -> ReferenceClip:
    """Forward kinematics of every frame, the frames as one batch."""
    d = pstep.make_data(m, mocap_qpos.shape[0], device=m.device)
    d = K.kinematics(m, d.replace(qpos=mocap_qpos.to(m.dtype)))
    if _free_root(m):
        return ReferenceClip(
            position=mocap_qpos[:, :3],
            quaternion=mocap_qpos[:, 3:7],
            joints=mocap_qpos[:, 7:],
            body_positions=d.xpos,
            body_quaternions=d.xquat,
        )
    return ReferenceClip(joints=mocap_qpos, body_positions=d.xpos, body_quaternions=d.xquat)


def compute_velocity_from_kinematics(qpos_trajectory: torch.Tensor, dt: float) -> torch.Tensor:
    """Finite-difference generalized velocities of a free-root trajectory."""
    qvel_translation = (qpos_trajectory[1:, :3] - qpos_trajectory[:-1, :3]) / dt
    diff = btm.quat_diff(qpos_trajectory[:-1, 3:7], qpos_trajectory[1:, 3:7])
    diff = diff / torch.linalg.norm(diff, dim=-1, keepdim=True)
    qvel_gyro = btm.quat_to_axis_angle(diff) / dt
    qvel_joints = (qpos_trajectory[1:, 7:] - qpos_trajectory[:-1, 7:]) / dt
    return torch.cat([qvel_translation, qvel_gyro, qvel_joints], dim=1)


def process_clip(
    m: M.Model, mocap_qpos: torch.Tensor, max_qvel: float = 20.0, dt: float = 0.02
) -> ReferenceClip:
    """One clip: features + velocities, on the model's device and dtype."""
    mocap_qpos = mocap_qpos.to(device=m.device, dtype=m.dtype)
    clip = extract_features(m, mocap_qpos)
    # pad the last frame so velocities have T entries
    mocap_qpos = torch.cat([mocap_qpos, mocap_qpos[-1:]], dim=0)
    if not _free_root(m):
        # tethered models: 6 zero root-velocity columns, identity root quat
        root = torch.zeros_like(mocap_qpos[:, :7])
        root[:, 3] = 1.0
        mocap_qpos = torch.cat([root, mocap_qpos], dim=1)
    qvel = compute_velocity_from_kinematics(mocap_qpos, dt)
    return clip.replace(
        velocity=qvel[:, :3],
        angular_velocity=qvel[:, 3:6],
        joints_velocity=torch.clamp(qvel[:, 6:], -max_qvel, max_qvel),
    )


# ---------------------------------------------------------------------------
# stac export ingestion
# ---------------------------------------------------------------------------


def _find_qpos(data, path="") -> list:
    """All (path, array) pairs whose key is ``qpos`` in a nested dict tree."""
    found = []
    if isinstance(data, dict):
        for k, v in data.items():
            p = f"{path}/{k}" if path else str(k)
            if str(k) == "qpos":
                found.append((p, v))
            else:
                found.extend(_find_qpos(v, p))
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            found.extend(_find_qpos(v, f"{path}[{i}]"))
    return found


def load_stac_qpos(stac_path: str, nq: Optional[int] = None) -> np.ndarray:
    """Loads a stac mocap qpos array from ``.h5`` or a pickle of numpy data.

    Accepted layouts, as the JAX package's: a top-level ``qpos`` dataset,
    exactly one ``qpos`` anywhere in a nested group tree, or several
    ``qpos`` datasets in sibling groups ("snips") concatenated in
    sorted-key order along time. The result must be a 2-D float array;
    ``nq``, when given, pins its width.
    """
    _, ext = os.path.splitext(stac_path)
    if ext in (".h5", ".hdf5"):
        from brax_tracking_tpu_torch.data import h5io

        data = h5io.load(stac_path)
    else:
        data = pickles.load(stac_path)
    if not isinstance(data, dict):
        raise ValueError(
            f"{stac_path}: expected a dict-like stac export, got "
            f"{type(data).__name__}"
        )
    found = _find_qpos(data)
    if not found:
        top = sorted(data.keys())[:12]
        raise KeyError(
            f"{stac_path}: no 'qpos' dataset anywhere in the file "
            f"(top-level keys: {top})"
        )
    arrays = []
    for p, v in sorted(found, key=lambda kv: kv[0]):
        a = np.asarray(v)
        if a.ndim != 2 or not np.issubdtype(a.dtype, np.floating):
            raise ValueError(
                f"{stac_path}: '{p}' has shape {a.shape} dtype {a.dtype}; "
                "expected a (frames, nq) float array"
            )
        arrays.append(a)
    widths = {a.shape[1] for a in arrays}
    if len(widths) != 1:
        raise ValueError(
            f"{stac_path}: snip qpos widths disagree: {sorted(widths)} "
            f"(paths: {[p for p, _ in found]})"
        )
    qpos = arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=0)
    if nq is not None and qpos.shape[1] != nq:
        raise ValueError(
            f"{stac_path}: qpos width {qpos.shape[1]} != model nq {nq} — "
            "wrong model/export pairing? (tethered models strip the free "
            "joint: nq differs by 7)"
        )
    return qpos


def clean_stac_qpos(
    qpos: np.ndarray,
    nan_policy: str = "error",
    max_nan_fraction: float = 0.1,
    quat_cols: Sequence[int] = (),
) -> np.ndarray:
    """NaN handling for lab exports (dropped-marker frames).

    ``nan_policy="error"`` raises on any non-finite value, naming frames;
    ``"interpolate"`` fills interior NaN frames per column by linear
    interpolation over time (quaternion columns renormalized after) and
    edge frames from the nearest valid one, and still raises when more than
    ``max_nan_fraction`` of the frames are bad.
    """
    bad = ~np.isfinite(qpos)
    if not bad.any():
        return qpos
    bad_frames = np.nonzero(bad.any(axis=1))[0]
    if nan_policy == "error":
        raise ValueError(
            f"stac qpos has non-finite values in {bad_frames.size} frames "
            f"(first few: {bad_frames[:8].tolist()}); pass "
            "nan_policy='interpolate' to repair dropped-marker frames"
        )
    if nan_policy != "interpolate":
        raise ValueError(f"unknown nan_policy {nan_policy!r}")
    if bad_frames.size > max_nan_fraction * qpos.shape[0]:
        raise ValueError(
            f"stac qpos has {bad_frames.size}/{qpos.shape[0]} non-finite "
            f"frames (> max_nan_fraction={max_nan_fraction}); refusing to "
            "interpolate — the export is likely corrupt"
        )
    out = qpos.copy()
    t = np.arange(qpos.shape[0])
    for c in range(qpos.shape[1]):
        col_bad = bad[:, c]
        if col_bad.any():
            good = ~col_bad
            out[col_bad, c] = np.interp(t[col_bad], t[good], qpos[good, c])
    for q0 in quat_cols:
        norms = np.linalg.norm(out[:, q0 : q0 + 4], axis=1, keepdims=True)
        out[:, q0 : q0 + 4] /= np.maximum(norms, 1e-12)
    return out


def _has_free_joint(m: M.Model) -> bool:
    return bool(np.any(np.asarray(m.jnt_type) == M.JNT_FREE))


def _expected_stac_nq(m: M.Model) -> Optional[int]:
    """Stac exports are fitted on the free-root model; a tethered model
    (free joint stripped) still ingests full-width exports, so nq is pinned
    only when the model keeps its free root."""
    return int(m.nq) if _has_free_joint(m) else None


def process_clip_to_train(
    stac_path: str,
    m: M.Model,
    start_step: int = 0,
    clip_length: int = 250,
    max_qvel: float = 20.0,
    dt: float = 0.02,
    nan_policy: str = "error",
) -> ReferenceClip:
    """Stac file -> ReferenceClip of frames ``[start_step, start_step +
    clip_length)`` on the model's device and dtype; a range past the
    file's end raises."""
    full = load_stac_qpos(stac_path, nq=_expected_stac_nq(m))
    if start_step + clip_length > full.shape[0]:
        raise ValueError(
            f"{stac_path}: clip [{start_step}, {start_step + clip_length}) "
            f"out of range — file has {full.shape[0]} frames "
            f"(clip_idx too large for this export?)"
        )
    mocap_qpos = clean_stac_qpos(
        full[start_step : start_step + clip_length],
        nan_policy=nan_policy,
        quat_cols=(3,) if _has_free_joint(m) else (),
    )
    return process_clip(m, torch.as_tensor(mocap_qpos), max_qvel=max_qvel, dt=dt)


# ---------------------------------------------------------------------------
# multi-clip stacking and the clip cache
# ---------------------------------------------------------------------------

_FIELDS = tuple(f.name for f in dataclasses.fields(ReferenceClip))
# the JAX package's clip class, as its pickles name it
_JAX_CLIP = ("brax_tracking_tpu.data.clips", "ReferenceClip")


def stack_clips(clips: Sequence[ReferenceClip]) -> ReferenceClip:
    """Stacks single clips into a multi-clip dataset (leading clip axis)."""
    out = {}
    for f in _FIELDS:
        values = [getattr(c, f) for c in clips]
        present = [v is not None for v in values]
        if any(present) and not all(present):
            raise ValueError(f"clips disagree on whether {f} is present")
        out[f] = torch.stack(values) if all(present) else None
    return ReferenceClip(**out)


def save_clip(path: str, clip: ReferenceClip) -> None:
    """Writes ``clip`` to ``path`` (``.npz``), one array per present field."""
    if not path.endswith(".npz"):
        raise ValueError(f"the port writes clip caches as .npz, not {path!r}")
    arrays = {f: getattr(clip, f).detach().cpu().numpy() for f in _FIELDS
              if getattr(clip, f) is not None}
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_clip(path: str) -> ReferenceClip:
    """Reads a clip cache as CPU tensors: the port's ``.npz`` or the JAX
    package's pickle (any other suffix)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        clip = pickles.load(path, {_JAX_CLIP: ReferenceClip})
        if not isinstance(clip, ReferenceClip):
            raise ValueError(f"{path} holds a {type(clip).__name__}, not a ReferenceClip")
        arrays = {k: v for k, v in vars(clip).items() if v is not None}
    unknown = set(arrays) - set(_FIELDS)
    if unknown:
        raise ValueError(f"{path}: unknown clip fields {sorted(unknown)}")
    return ReferenceClip(**{k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()})
