"""Interactive SLAM GUI: a tkinter shell around the production renderer
(port of `monogs_dev_tpu/viz/gui.py`).

The live map re-rendered from a mouse-orbitable camera through the renderer
the SLAM loop trains through (`render_view`, K1 on the card), in the modes
color | depth | opacity | ellipsoid; a pause toggle on the `VizChannel`'s
control queue (the frontend forwards it to the backend); follow-camera with
a from-behind offset, a keyframe viewpoint list, keyframe frusta, a
gaussian-scale slider, a screenshot button and the live gaussian count.

All view, camera and packet logic lives in `ViewerState`, which is headless
and tested; `SlamGUI` is a thin tk shell over it, with tkinter imported
inside. `Results.use_gui: True` makes `slam_torch.py` start `run_gui` on a
thread when there is an X display; without one use `OfflineViewer` or
`export_turntable`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..models.camera import Intrinsics
from ..ops.raster_types import RasterConfig
from .snapshot import GaussianPacket, PacketVis2Main
from .viewer import render_ellipsoids, render_view


@dataclass
class OrbitCamera:
    """Target-orbit camera; yaw/pitch in radians, OpenCV-style W2C out."""

    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 4.0
    yaw: float = 0.0
    pitch: float = -0.3

    def rotate(self, dyaw: float, dpitch: float) -> None:
        self.yaw += dyaw
        self.pitch = float(np.clip(self.pitch + dpitch, -1.45, 1.45))

    def zoom(self, factor: float) -> None:
        self.radius = float(np.clip(self.radius * factor, 0.05, 100.0))

    def pan(self, dx: float, dy: float) -> None:
        """Shift the target in the camera's image plane."""
        T = self.w2c()
        R = T[:3, :3]
        self.target = self.target + R.T @ np.array([dx, dy, 0.0])

    def w2c(self) -> np.ndarray:
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        # camera sits behind the target along -z of its own frame
        fwd = np.array([sy * cp, -sp, cy * cp])  # camera +z, toward target
        eye = self.target - self.radius * fwd
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= max(np.linalg.norm(right), 1e-9)
        up2 = np.cross(fwd, right)
        R_c2w = np.stack([right, up2, fwd], axis=1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_c2w.T
        T[:3, 3] = -R_c2w.T @ eye
        return T


class ViewerState:
    """Headless GUI core: packet ingestion, camera control, rendering,
    frusta overlay geometry. The tk shell only forwards events here."""

    MODES = ("color", "depth", "opacity", "ellipsoid")

    def __init__(self, intr: Intrinsics, raster_cfg: RasterConfig = RasterConfig()):
        self.intr = intr
        self.raster_cfg = raster_cfg
        self.camera = OrbitCamera()
        self.packet: Optional[GaussianPacket] = None
        self.mode = "color"
        self.follow = True
        self.from_behind = True
        self.show_cameras = True
        self.scale_modifier = 1.0
        self.paused = False
        self._centered = False

    # ------------------------------------------------------------ ingestion
    def ingest(self, packet: Optional[GaussianPacket]) -> bool:
        """Adopt the newest packet. Returns True when a redraw is needed."""
        if packet is None:
            return False
        packet.adopt()  # its map, on this thread's stream
        self.packet = packet
        if not self._centered and packet.xyz is not None and len(packet.xyz):
            self.camera.target = packet.xyz.mean(axis=0)
            self._centered = True
        return True

    def n_gaussians(self) -> int:
        return 0 if self.packet is None or self.packet.xyz is None else len(
            self.packet.xyz
        )

    def keyframe_list(self) -> List[int]:
        p = self.packet
        if p is None or p.keyframe_poses is None:
            return []
        return list(range(len(p.keyframe_poses)))

    # --------------------------------------------------------------- camera
    def view_matrix(self) -> np.ndarray:
        p = self.packet
        if self.follow and p is not None and p.current_frame_T is not None:
            T = np.asarray(p.current_frame_T, np.float32).copy()
            if self.from_behind:
                # step back 0.8 m and up 0.2 m in the current camera frame
                offset = np.eye(4, dtype=np.float32)
                offset[:3, 3] = [0.0, 0.2, 0.8]
                T = offset @ T
            return T
        return self.camera.w2c()

    def jump_to_keyframe(self, idx: int) -> None:
        p = self.packet
        if p is None or p.keyframe_poses is None:
            return
        if 0 <= idx < len(p.keyframe_poses):
            self.follow = False
            T = np.asarray(p.keyframe_poses[idx], np.float32)
            # re-seat the orbit so manual control continues from this view
            R, t = T[:3, :3], T[:3, 3]
            eye = -R.T @ t
            fwd = R.T @ np.array([0.0, 0.0, 1.0])
            self.camera.target = eye + self.camera.radius * fwd
            self.camera.yaw = math.atan2(fwd[0], fwd[2])
            self.camera.pitch = -math.asin(np.clip(fwd[1], -1.0, 1.0))

    # ------------------------------------------------------------ rendering
    def render(self) -> Optional[np.ndarray]:
        """(H, W, 3) float01 of the live map from the current view."""
        p = self.packet
        if p is None or p.params is None:
            return None
        T = self.view_matrix()
        if self.mode == "ellipsoid":
            return render_ellipsoids(
                p.params, p.active, T, self.intr, self.raster_cfg,
                scale_modifier=self.scale_modifier,
            )
        return render_view(
            p.params, p.active, T, self.intr, mode=self.mode,
            raster_cfg=self.raster_cfg, scale_modifier=self.scale_modifier,
        )

    def frusta_segments(self) -> List[Tuple[float, float, float, float]]:
        """Keyframe frusta projected into the current view: 2D line
        segments (x0, y0, x1, y1) in pixels."""
        p = self.packet
        if not self.show_cameras or p is None or p.keyframe_poses is None:
            return []
        T_view = self.view_matrix()
        intr = self.intr
        segs: List[Tuple[float, float, float, float]] = []
        d, wf, hf = 0.12, 0.08, 0.06  # frustum depth / half-extents (m)
        local = np.array(
            [
                [0.0, 0.0, 0.0],
                [-wf, -hf, d], [wf, -hf, d], [wf, hf, d], [-wf, hf, d],
            ]
        )
        edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        for T_kf in p.keyframe_poses:
            T_kf = np.asarray(T_kf, np.float64)
            R, t = T_kf[:3, :3], T_kf[:3, 3]
            corners_w = (local @ R) + (-R.T @ t)  # camera-frame -> world
            cam = corners_w @ T_view[:3, :3].T + T_view[:3, 3]
            z = cam[:, 2]
            if np.any(z <= 1e-3):
                continue
            px = intr.fx * cam[:, 0] / z + intr.cx
            py = intr.fy * cam[:, 1] / z + intr.cy
            for a, b in edges:
                segs.append((px[a], py[a], px[b], py[b]))
        return segs

    def toggle_pause(self) -> PacketVis2Main:
        self.paused = not self.paused
        return PacketVis2Main(flag_pause=self.paused)


def _to_photo_data(img01: np.ndarray) -> bytes:
    """float01 RGB -> binary PPM bytes (tk.PhotoImage native, no PIL-tk)."""
    arr = (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = arr.shape[:2]
    return b"P6 %d %d 255 " % (w, h) + arr.tobytes()


class SlamGUI:
    """tk shell: widgets + event loop around ViewerState."""

    def __init__(self, channel, intr: Intrinsics, raster_cfg=RasterConfig(),
                 poll_ms: int = 100):
        import tkinter as tk

        self.tk = tk
        self.channel = channel
        self.state = ViewerState(intr, raster_cfg)
        self.poll_ms = poll_ms

        self.root = tk.Tk()
        self.root.title("MonoGS")
        self.canvas = tk.Canvas(
            self.root, width=intr.width, height=intr.height, bg="black"
        )
        self.canvas.grid(row=0, column=0, rowspan=12)
        self._photo = None
        self._drag: Optional[Tuple[int, int, bool]] = None
        self.canvas.bind("<ButtonPress-1>", self._press)
        self.canvas.bind("<B1-Motion>", lambda e: self._drag_to(e, pan=False))
        self.canvas.bind("<ButtonPress-3>", self._press)
        self.canvas.bind("<B3-Motion>", lambda e: self._drag_to(e, pan=True))
        self.canvas.bind("<Button-4>", lambda e: self._zoom(0.9))
        self.canvas.bind("<Button-5>", lambda e: self._zoom(1.1))
        self.canvas.bind("<MouseWheel>",
                         lambda e: self._zoom(0.9 if e.delta > 0 else 1.1))

        col = 1
        self.pause_btn = tk.Button(
            self.root, text="Pause", command=self._toggle_pause
        )
        self.pause_btn.grid(row=0, column=col, sticky="ew")
        self.follow_var = tk.BooleanVar(value=True)
        tk.Checkbutton(
            self.root, text="Follow Camera", variable=self.follow_var,
            command=self._sync_flags,
        ).grid(row=1, column=col, sticky="w")
        self.behind_var = tk.BooleanVar(value=True)
        tk.Checkbutton(
            self.root, text="From Behind", variable=self.behind_var,
            command=self._sync_flags,
        ).grid(row=2, column=col, sticky="w")
        self.cameras_var = tk.BooleanVar(value=True)
        tk.Checkbutton(
            self.root, text="Cameras", variable=self.cameras_var,
            command=self._sync_flags,
        ).grid(row=3, column=col, sticky="w")
        self.mode_var = tk.StringVar(value="color")
        tk.OptionMenu(
            self.root, self.mode_var, *ViewerState.MODES,
            command=lambda _v: self._sync_flags(),
        ).grid(row=4, column=col, sticky="ew")
        tk.Label(self.root, text="Gaussian Scale").grid(row=5, column=col)
        self.scale_var = tk.DoubleVar(value=1.0)
        tk.Scale(
            self.root, from_=0.01, to=1.0, resolution=0.01,
            orient="horizontal", variable=self.scale_var,
            command=lambda _v: self._sync_flags(),
        ).grid(row=6, column=col, sticky="ew")
        self.kf_var = tk.StringVar(value="viewpoint…")
        self.kf_menu = tk.OptionMenu(self.root, self.kf_var, "")
        self.kf_menu.grid(row=7, column=col, sticky="ew")
        tk.Button(
            self.root, text="Screenshot", command=self._screenshot
        ).grid(row=8, column=col, sticky="ew")
        self.info = tk.Label(self.root, text="Number of Gaussians: 0")
        self.info.grid(row=9, column=col, sticky="w")

        self.root.after(self.poll_ms, self._tick)

    # --------------------------------------------------------------- events
    def _press(self, e):
        self._drag = (e.x, e.y, False)

    def _drag_to(self, e, pan: bool):
        if self._drag is None:
            self._drag = (e.x, e.y, pan)
            return
        x0, y0, _ = self._drag
        dx, dy = e.x - x0, e.y - y0
        self._drag = (e.x, e.y, pan)
        self.state.follow = False
        self.follow_var.set(False)
        if pan:
            s = self.state.camera.radius * 1e-3
            self.state.camera.pan(-dx * s, -dy * s)
        else:
            self.state.camera.rotate(dx * 5e-3, dy * 5e-3)

    def _zoom(self, factor: float):
        self.state.follow = False
        self.follow_var.set(False)
        self.state.camera.zoom(factor)

    def _toggle_pause(self):
        msg = self.state.toggle_pause()
        self.channel.request_pause(msg.flag_pause)
        self.pause_btn.config(text="Resume" if self.state.paused else "Pause")

    def _sync_flags(self):
        st = self.state
        st.follow = self.follow_var.get()
        st.from_behind = self.behind_var.get()
        st.show_cameras = self.cameras_var.get()
        st.mode = self.mode_var.get()
        st.scale_modifier = float(self.scale_var.get())

    def _jump(self, idx: int):
        self.state.jump_to_keyframe(idx)
        self.follow_var.set(False)

    def _screenshot(self):
        img = self.state.render()
        if img is not None:
            from .viewer import save_view_png

            save_view_png(img, f"gui_screenshot_{int(time.time())}.png")

    # ----------------------------------------------------------------- loop
    def _tick(self):
        packet = self.channel.latest()
        if packet is not None and packet.finish:
            self.root.destroy()
            return
        self.state.ingest(packet)
        self._redraw()
        self.root.after(self.poll_ms, self._tick)

    def _redraw(self):
        img = self.state.render()
        if img is not None:
            self._photo = self.tk.PhotoImage(data=_to_photo_data(img))
            self.canvas.delete("all")
            self.canvas.create_image(0, 0, image=self._photo, anchor="nw")
            for x0, y0, x1, y1 in self.state.frusta_segments():
                self.canvas.create_line(x0, y0, x1, y1, fill="#00ff88")
        self.info.config(
            text=f"Number of Gaussians: {self.state.n_gaussians()}"
        )
        kfs = self.state.keyframe_list()
        menu = self.kf_menu["menu"]
        if menu.index("end") != (len(kfs) - 1 if kfs else 0):
            menu.delete(0, "end")
            for i in kfs:
                menu.add_command(
                    label=f"keyframe {i}", command=lambda i=i: self._jump(i)
                )

    def run(self):
        self.root.mainloop()


def run_gui(channel, intr: Intrinsics, raster_cfg=RasterConfig()) -> None:
    """Blocking GUI entry (spawned on a thread by slam.py when use_gui)."""
    SlamGUI(channel, intr, raster_cfg).run()
