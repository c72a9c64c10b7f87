"""State carried across packages as flat dicts of numpy arrays.

Keys: ``params.<field>``, ``aux.<field>``, ``mu.<field>``, ``nu.<field>``
and ``count`` for a map; ``mu``, ``nu``, ``count`` for keyframe optimizer
state; the `KeyframeBatch` field names for a keyframe batch. A synthetic
scene's npz (the JAX package's scene, which `data/synthetic.py::load_scene`
reads) has the map's ``params.<field>`` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .gaussians import AdamMoments, GaussianMap, GaussianParams, MapAux


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def params_from_numpy(arrays: Dict[str, np.ndarray], device, prefix: str = "params.") -> GaussianParams:
    return GaussianParams(*[
        _t(arrays[prefix + f.name], device, torch.float32)
        for f in dataclasses.fields(GaussianParams)
    ])


def params_to_numpy(params: GaussianParams, prefix: str = "params.") -> Dict[str, np.ndarray]:
    return {prefix + f.name: getattr(params, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(GaussianParams)}


_AUX_DTYPES = {
    "active": torch.bool, "n_obs": torch.int32, "kf_id": torch.int32,
    "grad_accum": torch.float32, "denom": torch.float32, "max_radii": torch.float32,
}


def gaussian_map_from_numpy(arrays: Dict[str, np.ndarray], device) -> GaussianMap:
    """Every field of GaussianParams, MapAux and AdamMoments from numpy."""
    aux = MapAux(*[_t(arrays["aux." + name], device, dt) for name, dt in _AUX_DTYPES.items()])
    moments = AdamMoments(
        params_from_numpy(arrays, device, "mu."),
        params_from_numpy(arrays, device, "nu."),
        int(arrays["count"]),
    )
    return GaussianMap(params_from_numpy(arrays, device), aux, moments)


def gaussian_map_to_numpy(gmap: GaussianMap) -> Dict[str, np.ndarray]:
    out = params_to_numpy(gmap.params)
    out.update({"aux." + name: getattr(gmap.aux, name).detach().cpu().numpy()
                for name in _AUX_DTYPES})
    out.update(params_to_numpy(gmap.moments.mu, "mu."))
    out.update(params_to_numpy(gmap.moments.nu, "nu."))
    out["count"] = np.asarray(gmap.moments.count, np.int32)
    return out


def keyframe_opt_state_from_numpy(arrays: Dict[str, np.ndarray], device):
    from ..core.mapping import KeyframeOptState

    return KeyframeOptState(
        mu=_t(arrays["mu"], device, torch.float32),
        nu=_t(arrays["nu"], device, torch.float32),
        count=int(arrays["count"]),
    )


def keyframe_opt_state_to_numpy(state) -> Dict[str, np.ndarray]:
    return {"mu": state.mu.detach().cpu().numpy(), "nu": state.nu.detach().cpu().numpy(),
            "count": np.asarray(state.count, np.int32)}


def keyframe_batch_from_numpy(arrays: Dict[str, np.ndarray], device):
    from ..core.mapping import KeyframeBatch

    kw = {}
    for f in dataclasses.fields(KeyframeBatch):
        x = np.asarray(arrays[f.name])
        kw[f.name] = _t(x, device, torch.bool if x.dtype == bool else torch.float32)
    return KeyframeBatch(**kw)


def keyframe_batch_to_numpy(batch) -> Dict[str, np.ndarray]:
    return {f.name: getattr(batch, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(batch)}
