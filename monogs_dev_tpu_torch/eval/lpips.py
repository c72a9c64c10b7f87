"""LPIPS perceptual metric with an AlexNet backbone, in `F.conv2d` (port of
`monogs_dev_tpu/eval/lpips.py`).

AlexNet conv features at 5 depths, unit-normalized over channels, squared
differences weighted by the non-negative 1x1 "lin" weights, averaged over
space and summed over depths (Zhang et al., CVPR 2018).

Weights are looked up in the JAX package's order:
  1. an npz at $MONOGS_LPIPS_WEIGHTS or `lpips_weights.npz` beside this
     module (keys conv{i}_w, conv{i}_b, lin{i}_w; the canonical AlexNet-LPIPS
     v0.1 weights), tagged "alexnet-lpips-v0.1";
  2. otherwise a He-initialized random backbone with uniform lin weights,
     drawn from `torch.Generator().manual_seed(0)` and tagged
     "alexnet-random-torch". The JAX package's random backbone comes from
     `jax.random`, which torch cannot reproduce, so the tag differs from its
     "alexnet-random"; values from either random backbone are not
     comparable to published LPIPS.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, kernel, stride, pad) per AlexNet conv layer
_ALEX = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # maxpool(3, stride 2) after relu1 and relu2

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

CANONICAL = "alexnet-lpips-v0.1"


@dataclasses.dataclass(frozen=True)
class LPIPSParams:
    conv_w: Tuple[torch.Tensor, ...]  # (O, I, K, K) per layer
    conv_b: Tuple[torch.Tensor, ...]  # (O,) per layer
    lin_w: Tuple[torch.Tensor, ...]  # (O,) per layer
    backend: str

    def to(self, device) -> "LPIPSParams":
        def move(xs):
            return tuple(x.to(device) for x in xs)

        return LPIPSParams(move(self.conv_w), move(self.conv_b), move(self.lin_w), self.backend)


def random_lpips_params(seed: int = 0) -> LPIPSParams:
    """He-initialized backbone, zero biases, uniform lin weights."""
    gen = torch.Generator().manual_seed(seed)
    conv_w, conv_b, lin_w = [], [], []
    for o, i, k, _, _ in _ALEX:
        std = float(np.sqrt(2.0 / (i * k * k)))
        conv_w.append(torch.randn((o, i, k, k), generator=gen) * std)
        conv_b.append(torch.zeros(o))
        lin_w.append(torch.full((o,), 1.0 / o))
    return LPIPSParams(tuple(conv_w), tuple(conv_b), tuple(lin_w), "alexnet-random-torch")


def lpips_params_from_numpy(arrays: Dict[str, np.ndarray], backend: str) -> LPIPSParams:
    """Parameters from numpy arrays under the npz's keys (conv{i}_w,
    conv{i}_b, lin{i}_w): the canonical npz, or the JAX package's
    parameters carried across for the parity tests."""
    def t(key):
        return torch.tensor(np.asarray(arrays[key], np.float32))

    return LPIPSParams(tuple(t(f"conv{i}_w") for i in range(5)),
                       tuple(t(f"conv{i}_b") for i in range(5)),
                       tuple(t(f"lin{i}_w").reshape(-1) for i in range(5)), backend)


_DEFAULT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lpips_weights.npz")


@functools.lru_cache(maxsize=1)
def load_lpips_params() -> LPIPSParams:
    """The canonical weights if the npz is present, else the random backbone
    (on the CPU; `lpips` moves them to the images' device)."""
    path = os.environ.get("MONOGS_LPIPS_WEIGHTS", _DEFAULT_NPZ)
    if os.path.exists(path):
        with np.load(path) as z:
            return lpips_params_from_numpy(dict(z), CANONICAL)
    return random_lpips_params()


@functools.lru_cache(maxsize=4)
def _params_on(device: torch.device) -> LPIPSParams:
    return load_lpips_params().to(device)


def _features(x: torch.Tensor, params: LPIPSParams):
    """x (1, 3, H, W) normalized -> the 5 relu outputs (1, C, h, w)."""
    feats = []
    for li, (_, _, _, stride, pad) in enumerate(_ALEX):
        x = F.relu(F.conv2d(x, params.conv_w[li], params.conv_b[li], stride=stride,
                            padding=pad))
        feats.append(x)
        if li in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt((f * f).sum(dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips(img_a, img_b, params: Optional[LPIPSParams] = None) -> float:
    """LPIPS distance between two (H, W, 3) images in [0, 1] (tensors on
    one device, or numpy arrays, taken to the CPU)."""
    a = torch.as_tensor(img_a, dtype=torch.float32)
    b = torch.as_tensor(img_b, dtype=torch.float32, device=a.device)
    params = _params_on(a.device) if params is None else params.to(a.device)
    shift = torch.tensor(_SHIFT, device=a.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=a.device)[None, :, None, None]

    def prep(img):  # (H, W, 3) in [0, 1] -> normalized (1, 3, H, W)
        return (img.permute(2, 0, 1)[None] * 2.0 - 1.0 - shift) / scale

    total = torch.zeros((), device=a.device)
    for li, (fa, fb) in enumerate(zip(_features(prep(a), params), _features(prep(b), params))):
        d = _unit_normalize(fa) - _unit_normalize(fb)
        w = torch.clamp(params.lin_w[li], min=0.0)[None, :, None, None]
        total = total + (d * d * w).sum(dim=1).mean()
    return float(total)


def lpips_backend() -> str:
    return load_lpips_params().backend
