"""Visualization snapshot protocol (port of `monogs_dev_tpu/viz/snapshot.py`).

`GaussianPacket` is a snapshot of the map plus the current frame's context,
sent from the SLAM loop to a viewer; `VizChannel` is the latest-wins
main->viewer queue and the viewer->main pause channel.

The packet keeps references to the map's tensors, as the JAX package keeps
its immutable arrays: no map tensor is ever written in place (the mapping
step builds new ones), so a reference is a snapshot. A viewer on a thread
and CUDA stream of its own calls `adopt()` before it renders them.
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class GaussianPacket:
    """Snapshot for the viewer."""

    xyz: Optional[np.ndarray] = None  # (M, 3) active Gaussians
    rgb: Optional[np.ndarray] = None  # (M, 3)
    opacity: Optional[np.ndarray] = None  # (M,)
    scales: Optional[np.ndarray] = None  # (M, 3)
    current_frame_T: Optional[np.ndarray] = None  # (4, 4) W2C
    gt_color: Optional[np.ndarray] = None  # (H, W, 3) current frame
    gt_depth: Optional[np.ndarray] = None
    keyframe_poses: Optional[List[np.ndarray]] = None
    kf_window: Optional[Dict[int, list]] = None
    # the whole map by reference, for re-rendering it with the same renderer
    params: Optional[object] = None  # GaussianParams
    active: Optional[torch.Tensor] = None  # (N,) bool
    # the CUDA event after which params and active are ready (None off the card)
    ready: Optional[object] = None
    finish: bool = False

    @staticmethod
    def from_map(params, active, ready=None, **kwargs) -> "GaussianPacket":
        """A packet of the map (params, active): host copies of the active
        rows, taken on the current stream after `ready`."""
        from ..core.backend import adopt_on_stream, device_tensors
        from ..geometry.sh import sh_to_rgb
        from ..models.gaussians import activations

        adopt_on_stream(ready, device_tensors(params, active), active.device)
        with torch.no_grad():
            scales, _, opacity = activations(params)
            rgb = torch.clamp(sh_to_rgb(params.f_dc[:, 0, :]), 0.0, 1.0)

            def host(x):
                return x[active].cpu().numpy()

            return GaussianPacket(xyz=host(params.xyz), rgb=host(rgb), opacity=host(opacity),
                                  scales=host(scales), params=params, active=active,
                                  ready=ready, **kwargs)

    def adopt(self) -> None:
        """Order the current stream after the packet's map and mark its
        tensors as used there (see `core/backend.py::adopt_on_stream`)."""
        from ..core.backend import adopt_on_stream, device_tensors

        adopt_on_stream(self.ready, device_tensors(self.params, self.active),
                        self.active.device)


@dataclasses.dataclass
class PacketVis2Main:
    """viewer -> main control message."""

    flag_pause: bool = False


class VizChannel:
    """Bidirectional viewer channel with latest-wins delivery."""

    def __init__(self, maxsize: int = 4):
        self.q_main2vis: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.q_vis2main: "queue.Queue" = queue.Queue()

    def publish(self, packet: GaussianPacket) -> None:
        """Non-blocking; drops the oldest packet when the viewer lags."""
        try:
            self.q_main2vis.put_nowait(packet)
        except queue.Full:
            try:
                self.q_main2vis.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q_main2vis.put_nowait(packet)
            except queue.Full:
                pass

    def latest(self) -> Optional[GaussianPacket]:
        """Drain to the newest packet."""
        packet = None
        while True:
            try:
                packet = self.q_main2vis.get_nowait()
            except queue.Empty:
                return packet

    def request_pause(self, pause: bool) -> None:
        self.q_vis2main.put(PacketVis2Main(flag_pause=pause))

    def poll_control(self) -> Optional[PacketVis2Main]:
        try:
            return self.q_vis2main.get_nowait()
        except queue.Empty:
            return None
