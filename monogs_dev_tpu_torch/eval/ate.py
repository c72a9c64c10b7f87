"""Absolute trajectory error with Umeyama alignment (port of
`monogs_dev_tpu/eval/ate.py`).

Keyframe C2W trajectories are aligned with a closed-form Umeyama similarity
(scale-corrected for monocular) and scored as translation RMSE; `eval_ate`
writes the trajectory json, the stats json and, where matplotlib is
installed, a 2D plot.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.logging import Log


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning x -> y, (3, N) each: y ~ c R x + t."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    u, d, vt = np.linalg.svd(yc @ xc.T / n)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    c = float(np.trace(np.diag(d) @ s) / max((xc ** 2).sum() / n, 1e-12)) if with_scale else 1.0
    t = my[:, 0] - c * r @ mx[:, 0]
    return r, t, c


def ate_rmse(T_est: List[np.ndarray], T_gt: List[np.ndarray], correct_scale: bool = False) -> float:
    """ATE translation RMSE over W2C pose lists, Umeyama-aligned."""
    pos_est = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in T_est], axis=1)
    pos_gt = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in T_gt], axis=1)
    if pos_est.shape[1] < 3:
        return float(np.sqrt(((pos_est - pos_gt) ** 2).sum(axis=0).mean()))
    r, t, c = umeyama_alignment(pos_est, pos_gt, with_scale=correct_scale)
    err = c * r @ pos_est + t[:, None] - pos_gt
    return float(np.sqrt((err ** 2).sum(axis=0).mean()))


def eval_ate(cameras: Dict[int, "FrameInfo"], kf_ids: List[int],  # noqa: F821
             save_dir: Optional[str], iterations: int, final: bool = False,
             monocular: bool = False) -> float:
    """Keyframe-trajectory ATE (m) of the frontend's `cameras`, with the
    trj_<label>.json, plot/stats_<label>.json and plot/trj_<label>.png
    artifacts in `save_dir`."""
    trj_id, trj_est, trj_gt, est, gt = [], [], [], [], []
    for kf_id in kf_ids:
        cam = cameras[kf_id]
        T_est = np.asarray(cam.T_est, np.float64)
        T_gt = np.asarray(cam.T_gt, np.float64)
        trj_id.append(int(cam.idx))
        trj_est.append(np.linalg.inv(T_est).tolist())
        trj_gt.append(np.linalg.inv(T_gt).tolist())
        est.append(T_est)
        gt.append(T_gt)
    ate = ate_rmse(est, gt, correct_scale=monocular)
    Log(f"ATE RMSE (cm): {ate * 100:.3f}", tag="Eval")

    if save_dir is not None:
        plot_dir = os.path.join(save_dir, "plot")
        os.makedirs(plot_dir, exist_ok=True)
        label = "final" if final else str(iterations)
        with open(os.path.join(save_dir, f"trj_{label}.json"), "w", encoding="utf-8") as f:
            json.dump({"trj_id": trj_id, "trj_est": trj_est, "trj_gt": trj_gt}, f)
        with open(os.path.join(plot_dir, f"stats_{label}.json"), "w", encoding="utf-8") as f:
            json.dump({"rmse": ate, "n_kf": len(kf_ids)}, f, indent=2)
        _plot_trajectory(est, gt, monocular, plot_dir, label, ate)
    return ate


def _plot_trajectory(T_est, T_gt, monocular, plot_dir, label, ate) -> None:
    """Aligned estimate and ground truth in the x-y plane, as a PNG; skipped
    with a log line where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as e:
        Log(f"trajectory plot skipped: {e}", tag="Eval")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos_est = np.stack([np.linalg.inv(T)[:3, 3] for T in T_est], axis=1)
    pos_gt = np.stack([np.linalg.inv(T)[:3, 3] for T in T_gt], axis=1)
    if pos_est.shape[1] >= 3:
        r, t, c = umeyama_alignment(pos_est, pos_gt, with_scale=monocular)
        pos_est = c * r @ pos_est + t[:, None]
    fig, ax = plt.subplots()
    ax.plot(pos_gt[0], pos_gt[1], label="GT", color="k", lw=1)
    ax.plot(pos_est[0], pos_est[1], label="est", color="tab:blue", lw=1)
    ax.set_title(f"ATE RMSE {ate * 100:.2f} cm")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(os.path.join(plot_dir, f"trj_{label}.png"), dpi=90)
    plt.close(fig)
