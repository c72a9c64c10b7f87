"""PLY snapshots in the standard 3DGS attribute layout (port of
`monogs_dev_tpu/utils/ply.py`).

Binary little-endian PLY with per-vertex attributes
x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*, features stored
channel-major as 3DGS viewers expect; written and read with numpy
structured arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..models.gaussians import GaussianParams


def _field_names(n_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(params: GaussianParams, active, path: str) -> int:
    """Write the active Gaussians; returns the number written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mask = _np(active).astype(bool)
    xyz = _np(params.xyz)[mask]
    n = xyz.shape[0]
    f_dc = _np(params.f_dc)[mask]  # (n, 1, 3)
    f_rest = _np(params.f_rest)[mask]  # (n, R, 3)
    n_rest = f_rest.shape[1]

    names = _field_names(n_rest)
    data = np.zeros(n, dtype=np.dtype([(name, "<f4") for name in names]))
    data["x"], data["y"], data["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    dc = f_dc.transpose(0, 2, 1).reshape(n, -1)  # (n, 3)
    for i in range(3):
        data[f"f_dc_{i}"] = dc[:, i]
    rest = f_rest.transpose(0, 2, 1).reshape(n, -1)  # (n, 3R), channel-major
    for i in range(3 * n_rest):
        data[f"f_rest_{i}"] = rest[:, i]
    data["opacity"] = _np(params.opacity_logit)[mask]
    scales = _np(params.log_scales)[mask]
    rots = _np(params.quats)[mask]
    for i in range(3):
        data[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        data[f"rot_{i}"] = rots[:, i]

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {name}" for name in names]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        data.tofile(f)
    return n


def load_ply(path: str) -> Tuple[GaussianParams, torch.Tensor]:
    """Read a 3DGS PLY back into (params, active) on the CPU, one row per
    vertex."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.fromfile(f, dtype=np.dtype([(name, "<f4") for name in names]), count=n)

    n_rest = sum(1 for name in names if name.startswith("f_rest_")) // 3
    dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], axis=-1)[:, None, :]
    if n_rest > 0:
        rest = np.stack([data[f"f_rest_{i}"] for i in range(3 * n_rest)],
                        axis=-1).reshape(n, 3, n_rest).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32))

    params = GaussianParams(
        xyz=t(np.stack([data["x"], data["y"], data["z"]], axis=-1)),
        f_dc=t(dc), f_rest=t(rest),
        log_scales=t(np.stack([data[f"scale_{i}"] for i in range(3)], -1)),
        quats=t(np.stack([data[f"rot_{i}"] for i in range(4)], -1)),
        opacity_logit=t(data["opacity"]),
    )
    return params, torch.ones((n,), dtype=torch.bool)
