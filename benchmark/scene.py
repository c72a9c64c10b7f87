"""A session's input sequence, made from its seed: a textured relief of
Gaussians, a camera path over it, and the frames rendered by the
plain renderer and written in the dataset's own layout.

The relief is the arithmetic of the port's `data/synthetic.py::
surface_draws` / `make_surface_scene` (the bench scene of
`configs/synthetic/bench_vga.yaml`): x, y uniform over the extents, a
height field of sines plus normal noise, a colour field plus a uniform
jitter, flattened splats of one scale, opacity 0.95. The draws come from
CPU `torch.Generator`s, so a seed gives the same scene on every device.
Session k's geometry (x, y, the relief's noise) is drawn from k alone and
its colour jitter from the run's seed: every run gives its sessions the
same shapes under the same camera paths, so that the work (keyframes,
mapping rounds) does not change from seed to seed, and fresh texture, so
that each run checks the port on images it has not seen.

The camera path: frame i at yaw w i, its centre on a circle of radius
R = v / w about a point behind the camera, so that it turns at w and moves
sideways at v, the way it turns: it pans, and every frame shows some of the
relief that the frames before did not. w and v are the traffic's
`rad_per_frame` and `m_per_frame`, at every frame.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.render import C0, Camera, sensor_frame

JPEG_QUALITY = 95  # the quality of the port's own JPEG writer (data/image_io.py)


def surface_scene(shape_seed: int, colour_seed: int, n: int, extent_x: float,
                  extent_y: float, z_base: float, scale: float,
                  device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    g = torch.Generator().manual_seed(int(shape_seed))
    x = torch.rand((n,), generator=g) * (2 * extent_x) - extent_x
    y = torch.rand((n,), generator=g) * (2 * extent_y) - extent_y
    noise = torch.randn((n,), generator=g)
    jitter = torch.rand((n, 3), generator=torch.Generator().manual_seed(int(colour_seed)))
    jitter = jitter * 2.0 - 1.0
    z = (z_base + 0.6 * torch.sin(2.0 * x) + 0.4 * torch.cos(3.0 * y)
         + 0.15 * torch.sin(5.0 * x) * torch.cos(4.0 * y) + 0.03 * noise)
    base = 0.5 + 0.35 * torch.stack([torch.sin(1.3 * x + 2.1 * y),
                                     torch.sin(2.2 * x - 1.1 * y + 1.0),
                                     torch.cos(1.7 * x + 0.6 * y)], dim=-1)
    rgb = torch.clamp(base + 0.15 * jitter, 0.02, 0.98)
    log_s = math.log(scale)
    scene = {
        "xyz": torch.stack([x, y, z], dim=-1),
        "f_dc": ((rgb - 0.5) / C0)[:, None, :],
        "log_scales": torch.tensor([log_s, log_s, math.log(0.3 * scale)]).expand(n, 3).clone(),
        "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1),
        "opacity_logit": torch.full((n,), math.log(0.95 / 0.05)),
    }
    return ({k: v.to(device) for k, v in scene.items()},
            torch.ones((n,), dtype=torch.bool, device=device))


def loop_pose(i: int, rad_per_frame: float, m_per_frame: float) -> np.ndarray:
    """W2C (4, 4) float64 of frame i of the camera path."""
    yaw = rad_per_frame * i
    radius = m_per_frame / rad_per_frame if rad_per_frame else 0.0
    c, s = math.cos(yaw), math.sin(yaw)
    T_c2w = np.eye(4)
    T_c2w[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    T_c2w[:3, 3] = (radius * s, 0.0, radius * (1.0 - c))
    return np.linalg.inv(T_c2w)


def quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (x, y, z, w), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[3] = (R[k, j] - R[j, k]) / s
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return q


def camera_of(dataset_cfg: dict) -> Camera:
    cal = dataset_cfg["Calibration"]
    return Camera(fx=float(cal["fx"]), fy=float(cal["fy"]), cx=float(cal["cx"]),
                  cy=float(cal["cy"]), width=int(cal["width"]), height=int(cal["height"]))


def frames_u8_u16(color: torch.Tensor, depth: torch.Tensor, depth_scale: float):
    rgb = torch.round(color * 255.0).to(torch.uint8).cpu().numpy()
    d = torch.clamp(torch.round(depth * depth_scale), 0, 65535).to(torch.int32).cpu().numpy()
    return rgb, d.astype(np.uint16)


def write_sequence(layout: str, out_dir: str, scene, active, cam: Camera,
                   poses: List[np.ndarray], depth_scale: float) -> None:
    """`tum`: rgb/<ts>.png, depth/<ts>.png (16-bit), rgb.txt, depth.txt,
    groundtruth.txt (ts tx ty tz qx qy qz qw, C2W) at 30 Hz. `replica`:
    results/frame%06d.jpg (baseline, 4:2:0), results/depth%06d.png (16-bit),
    traj.txt (a flat C2W a line). Written with PIL (the port reads them with
    its own decoders)."""
    from PIL import Image

    dev = scene["xyz"].device
    if layout == "tum":
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    elif layout == "replica":
        os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    rgb_lines, depth_lines, gt_lines, traj = [], [], ["# ts tx ty tz qx qy qz qw"], []
    for i, T in enumerate(poses):
        color, depth = sensor_frame(scene, active, torch.tensor(T, dtype=torch.float32,
                                                                device=dev), cam)
        rgb, d16 = frames_u8_u16(color, depth, depth_scale)
        T_c2w = np.linalg.inv(T)
        if layout == "tum":
            ts = f"{i / 30.0:.6f}"
            Image.fromarray(rgb, "RGB").save(os.path.join(out_dir, "rgb", f"{ts}.png"),
                                             compress_level=1)
            Image.fromarray(d16).save(os.path.join(out_dir, "depth", f"{ts}.png"),
                                      compress_level=1)
            rgb_lines.append(f"{ts} rgb/{ts}.png")
            depth_lines.append(f"{ts} depth/{ts}.png")
            q = quat_xyzw(T_c2w[:3, :3])
            t = T_c2w[:3, 3]
            gt_lines.append(f"{ts} " + " ".join(f"{v:.9f}" for v in (*t, *q)))
        else:
            Image.fromarray(rgb, "RGB").save(
                os.path.join(out_dir, "results", f"frame{i:06d}.jpg"), quality=JPEG_QUALITY,
                subsampling=2, optimize=False, progressive=False)
            Image.fromarray(d16).save(os.path.join(out_dir, "results", f"depth{i:06d}.png"),
                                      compress_level=1)
            traj.append(" ".join(f"{v:.17g}" for v in T_c2w.reshape(-1)))
    files = ({"rgb.txt": rgb_lines, "depth.txt": depth_lines, "groundtruth.txt": gt_lines}
             if layout == "tum" else {"traj.txt": traj})
    for name, lines in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def session_seed(seed: int, sessions: int, k: int) -> int:
    return sessions * int(seed) + k


def sequence(cfg: dict, traffic: dict, seed: int, k: int, root: str, device):
    """(directory, GT W2C poses) of session k's sequence, written anew
    under `root/s<k>` (a fixed directory: every run makes its data, so
    that every run's set-up does the same work)."""
    s = session_seed(seed, traffic["sessions"], k)
    n = int(traffic["frames"])
    poses = [loop_pose(i, traffic["rad_per_frame"], traffic["m_per_frame"]) for i in range(n)]
    out = os.path.join(root, f"s{k}")
    shutil.rmtree(out, ignore_errors=True)
    sc = cfg["scene"]
    scene, active = surface_scene(k, s, sc["n_gaussians"], sc["extent_x"], sc["extent_y"],
                                  sc["z_base"], sc["gaussian_scale"], device)
    ds = cfg["config"]["Dataset"]
    write_sequence(cfg["layout"], out, scene, active, camera_of(ds), poses,
                   float(ds["Calibration"]["depth_scale"]))
    return out, poses
