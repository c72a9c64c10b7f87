"""Full-state checkpoint and resume (port of `monogs_dev_tpu/utils/checkpoint.py`).

One compressed npz under the JAX package's own keys, so that a file either
package writes restores in the other:
  params.<field>, mu.<field>, nu.<field>, aux.<field>  the map, at its tier's rows
  moments.count                                        the map's Adam step
  iteration_count, current_window, initialized         the backend counters
  kf_ids, kf_T, kf_exposure                            keyframe poses, exposures
  trj_ids, trj_est, trj_gt, trj_exposure, trj_is_kf    the frontend trajectory
  kf_indices_all, fe_window, fe_initialized, fe_median_depth, fe_anchor_idx,
  fe_next_frame                                        the frontend state
Pixels are not stored: a resume rebuilds each keyframe's image and depth
from the dataset (`FrontEnd._load_frame`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..models.convert import gaussian_map_from_numpy, gaussian_map_to_numpy
from ..models.gaussians import GaussianMap

HOST_KEYS = ("trj_exposure", "trj_is_kf", "kf_indices_all", "fe_window", "fe_initialized",
             "fe_median_depth", "fe_anchor_idx", "fe_next_frame")


def save_checkpoint(path: str, engine, frontend=None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = gaussian_map_to_numpy(engine.gmap)
    data["moments.count"] = data.pop("count")  # models/convert.py's key is `count`
    data["iteration_count"] = np.asarray(engine.iteration_count)
    data["current_window"] = np.asarray(engine.current_window, np.int64)
    data["initialized"] = np.asarray(engine.initialized)
    kf_ids = sorted(engine.viewpoints)
    data["kf_ids"] = np.asarray(kf_ids, np.int64)
    data["kf_T"] = (np.stack([np.asarray(engine.viewpoints[i].T_w2c) for i in kf_ids])
                    if kf_ids else np.zeros((0, 4, 4)))
    data["kf_exposure"] = (np.stack([np.asarray(engine.viewpoints[i].exposure) for i in kf_ids])
                           if kf_ids else np.zeros((0, 2)))
    if frontend is not None:
        ids = sorted(frontend.cameras)
        cams = [frontend.cameras[i] for i in ids]
        data["trj_ids"] = np.asarray(ids, np.int64)
        data["trj_est"] = np.stack([c.T_est for c in cams]) if ids else np.zeros((0, 4, 4))
        data["trj_gt"] = np.stack([c.T_gt for c in cams]) if ids else np.zeros((0, 4, 4))
        data["trj_exposure"] = (np.stack([np.asarray(c.exposure) for c in cams])
                                if ids else np.zeros((0, 2)))
        data["trj_is_kf"] = np.asarray([c.is_keyframe for c in cams], bool)
        data["kf_indices_all"] = np.asarray(frontend.kf_indices, np.int64)
        data["fe_window"] = np.asarray(frontend.current_window, np.int64)
        data["fe_initialized"] = np.asarray(frontend.initialized)
        data["fe_median_depth"] = np.asarray(frontend.median_depth)
        data["fe_anchor_idx"] = np.asarray(frontend.anchor_idx)
        data["fe_next_frame"] = np.asarray(frontend.cur_frame_idx)
    np.savez_compressed(path, **data)


def load_map(path: str, device) -> Tuple[GaussianMap, dict]:
    """The map on `device` at the row count it was saved with, and a dict
    of the host-side state."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["count"] = arrays["moments.count"]
    gmap = gaussian_map_from_numpy(arrays, device)
    host = {
        "iteration_count": int(arrays["iteration_count"]),
        "current_window": [int(i) for i in arrays["current_window"]],
        "initialized": bool(arrays["initialized"]),
        "kf_ids": [int(i) for i in arrays["kf_ids"]],
        "kf_T": np.asarray(arrays["kf_T"]),
        "kf_exposure": np.asarray(arrays["kf_exposure"]),
    }
    if "trj_ids" in arrays:
        host["trj_ids"] = [int(i) for i in arrays["trj_ids"]]
        host["trj_est"] = np.asarray(arrays["trj_est"])
        host["trj_gt"] = np.asarray(arrays["trj_gt"])
    for key in HOST_KEYS:
        if key in arrays:
            host[key] = np.asarray(arrays[key])
    return gmap, host


def restore_checkpoint(path: str, engine, frontend) -> int:
    """Restore the map, its Adam moments and the counters on the backend
    engine and the trajectory, window and keyframes on the frontend;
    returns the next frame to process (`FrontEnd.run` continues from it).

    As the JAX package's restore: keyframe images come back from the
    dataset, the keyframe optimizer's state is rebuilt at the next mapping
    round, and the occlusion-aware visibility is harvested again with one
    mapping iteration over the restored window (so the map after a resume
    is one Adam step past the saved one)."""
    from ..core.frontend import FrameInfo
    from ..core.keyframe import Keyframe

    gmap, host = load_map(path, engine.device)
    engine.gmap = gmap
    engine.iteration_count = host["iteration_count"]
    engine.current_window = list(host["current_window"])
    engine.initialized = host["initialized"]
    engine.kf_state = None
    engine._grow_pending = False
    engine.occ_aware_visibility = {}
    engine.viewpoints = {}
    frontend._prefetch = {}
    for kf_id, T, exp in zip(host["kf_ids"], host["kf_T"], host["kf_exposure"]):
        image, depth, T_gt = frontend._load_frame(kf_id)
        engine.viewpoints[kf_id] = Keyframe(
            idx=kf_id, image=image, depth=depth if engine.use_depth else None,
            T_w2c=np.asarray(T), exposure=np.asarray(exp), T_gt=T_gt)

    frontend.cameras = {}
    ids = host.get("trj_ids", [])
    exps = host.get("trj_exposure", np.zeros((len(ids), 2)))
    iskf = host.get("trj_is_kf", np.zeros(len(ids), bool))
    for k, fid in enumerate(ids):
        frontend.cameras[fid] = FrameInfo(idx=fid, T_est=host["trj_est"][k],
                                          T_gt=host["trj_gt"][k], exposure=np.asarray(exps[k]),
                                          is_keyframe=bool(iskf[k]))
    frontend.kf_indices = [int(i) for i in host.get("kf_indices_all", host["kf_ids"])]
    frontend.current_window = [int(i) for i in host.get("fe_window", host["current_window"])]
    frontend.initialized = bool(host.get("fe_initialized", host["initialized"]))
    frontend.median_depth = float(host.get("fe_median_depth", 4.0))
    frontend.anchor_idx = int(host.get("fe_anchor_idx", 0))
    frontend.reset = False
    frontend.requested_init = False
    frontend.requested_keyframe = 0

    if engine.current_window:
        engine.map(iters=1, harvest=True)
    frontend._sync_direct("resume")

    next_frame = int(host.get("fe_next_frame", (max(ids) + 1) if ids else 0))
    frontend.cur_frame_idx = next_frame
    return next_frame
