from .snapshot import GaussianPacket, VizChannel
from .viewer import (
    OfflineViewer,
    export_turntable,
    orbit_poses,
    render_ellipsoids,
    render_view,
    save_view_png,
)

__all__ = [
    "GaussianPacket",
    "VizChannel",
    "OfflineViewer",
    "export_turntable",
    "orbit_poses",
    "render_ellipsoids",
    "render_view",
    "save_view_png",
]
