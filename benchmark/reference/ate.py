"""Absolute trajectory error: camera centres aligned to the ground truth by
a least-squares rigid motion (Umeyama 1991, no scale for RGB-D), then the
RMSE of the translation residuals."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def umeyama(x: np.ndarray, y: np.ndarray):
    """(R, t) minimising sum |R x_i + t - y_i|^2 over (3, N) point sets."""
    mx, my = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
    u, _, vt = np.linalg.svd((y - my) @ (x - mx).T / x.shape[1])
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    return r, my[:, 0] - r @ mx[:, 0]


def centres(T_w2c: Sequence[np.ndarray]) -> np.ndarray:
    return np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in T_w2c], axis=1)


def residuals(T_est: Sequence[np.ndarray], T_gt: Sequence[np.ndarray]) -> np.ndarray:
    """Squared translation residuals (N,) after the alignment (none below
    three poses)."""
    est, gt = centres(T_est), centres(T_gt)
    if est.shape[1] >= 3:
        r, t = umeyama(est, gt)
        est = r @ est + t[:, None]
    return ((est - gt) ** 2).sum(axis=0)


def ate_rmse(sessions: List[tuple]) -> float:
    """RMSE over every pose of every (T_est, T_gt) session, each session
    aligned on its own (each has its own world frame)."""
    sq = np.concatenate([residuals(e, g) for e, g in sessions])
    return float(np.sqrt(sq.mean()))
