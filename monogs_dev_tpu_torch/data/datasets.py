"""Dataset loaders: TUM, Replica, EuRoC stereo, Realsense live and replay
(port of `monogs_dev_tpu/data/datasets.py`).

`dataset[idx]` returns what the port's `SyntheticDataset` returns:
(image (H, W, 3) float32 in [0, 1], depth (H, W) float32 or None, both on
the dataset's device, and the W2C ground-truth pose as a float64 numpy
array). Frames are decoded when asked for, never cached: a real sequence
runs to thousands of frames.

The parsers are the JAX package's, line for line (TUM timestamp association
within 0.08 s and 32 Hz subsampling, Replica's C2W `traj.txt` inverted,
EuRoC's ground truth through the body-to-cam0 extrinsic). Images are read
without PIL or cv2 (`image_io` for PNG, `jpeg` for JPEG, the format from
the file's first bytes): the PNG rows are unfiltered, and the JPEG scans
entropy-decoded into quantised coefficients, in pinned host memory on a
CUDA device, copied to the device without blocking the host, where the
JPEG's inverse DCT, upsampling and colour conversion run, and then the
arithmetic of the JAX loader: `/ 255` then clip, depth as float32 `/ depth_scale`, stereo depth as
`BASELINE_FX / disparity` with the loader's `== 0 -> 1e10` and `< 0 -> 0`
steps. Undistortion and rectification resample with `camera_maps`, and the
stereo disparity comes from `stereo.sgbm_disparity` on the device.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import List

import numpy as np
import torch

from . import camera_maps, image_io, jpeg
from .stereo import sgbm_disparity


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s in float32 element by element, as numpy divides a float32 array
    by a Python float (a tensor divided by a Python scalar is computed
    otherwise: on a CUDA tensor as a product with 1/s)."""
    return x / torch.full_like(x, s)


def _quat_xyzw_to_matrix(quat: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> 4x4 homogeneous rotation."""
    x, y, z, w = quat
    n = x * x + y * y + z * z + w * w
    if n < 1e-12:
        return np.eye(4)
    s = 2.0 / n
    T = np.eye(4)
    T[:3, :3] = np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
            [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
            [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
        ]
    )
    return T


class FrameReader:
    """Reads PNG and JPEG files onto a device: PNG rows unfiltered, JPEG
    scans entropy-decoded (`jpeg.decode_coefficients`), into pinned host
    memory (CUDA) or plain host memory (CPU), then one copy to the device,
    non-blocking from pinned memory; a JPEG's device stage
    (`jpeg.reconstruct`) runs there."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"

    def _host(self, decode, data: bytes, dtype):
        """decode(data, alloc=...) into a host tensor of `dtype` (pinned on a
        CUDA device); (decode's info, that tensor on the device)."""
        held = {}

        def alloc(shape):
            held["t"] = torch.empty(shape, dtype=dtype, pin_memory=self.pin)
            return held["t"].numpy()

        info, _ = decode(data, alloc=alloc)
        return info, held["t"].to(self.device, non_blocking=self.pin)

    def samples(self, path: str) -> torch.Tensor:
        """The file's samples on the device: uint8 (H, W[, C]) or, 16-bit,
        int32 (H, W)."""
        with open(path, "rb") as f:
            data = f.read()
        if image_io.image_format(data) == "jpeg":
            return jpeg.reconstruct(*self._host(jpeg.decode_coefficients, data, torch.int16))
        info, rows = self._host(image_io.decode_rows, data, torch.uint8)
        if info.sample_bytes == 2:  # big-endian samples
            rows = rows.view(info.height, -1, 2).to(torch.int32)
            return (rows[..., 0] << 8) | rows[..., 1]
        shape = (info.height, info.width) + ((info.channels,) if info.channels > 1 else ())
        return rows.view(shape)

    def gray(self, path: str) -> torch.Tensor:
        """uint8 (H, W), as `cv2.imread(path, 0)` reads an 8-bit file: a
        colour file goes through libpng's RGB-to-gray, (9797 R + 19234 G +
        3737 B) >> 15."""
        img = self.samples(path)
        if img.dtype != torch.uint8:
            raise ValueError(f"{path}: a 16-bit stereo image is not supported")
        if img.dim() == 2:
            return img
        c = img[..., :3].to(torch.int32)
        return ((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2]) >> 15).to(torch.uint8)


class BaseDataset:
    """Common intrinsics container + sequence interface."""

    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)
        self.reader = FrameReader(self.device)
        calibration = config["Dataset"]["Calibration"]
        self.fx = float(calibration["fx"])
        self.fy = float(calibration["fy"])
        self.cx = float(calibration["cx"])
        self.cy = float(calibration["cy"])
        self.width = int(calibration["width"])
        self.height = int(calibration["height"])
        self.has_depth = "depth_scale" in calibration
        self.depth_scale = float(calibration["depth_scale"]) if self.has_depth else None
        self.num_imgs = 0

    def __len__(self) -> int:
        return self.num_imgs

    def __getitem__(self, idx: int):
        raise NotImplementedError

    @staticmethod
    def _to_unit(image: torch.Tensor) -> torch.Tensor:
        return torch.clamp(_div(image.to(torch.float32), 255.0), 0.0, 1.0)


# ---------------------------------------------------------------------------
# parsers


class ReplicaParser:
    """results/frame*.jpg + depth*.png; traj.txt rows are flat C2W 4x4."""

    def __init__(self, input_folder: str):
        self.color_paths = sorted(glob.glob(f"{input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = []
        for i in range(self.n_img):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            self.poses.append(np.linalg.inv(c2w))


class TUMParser:
    """rgb/depth/groundtruth timestamp association at 32 Hz."""

    def __init__(self, input_folder: str, frame_rate: int = 32):
        pose_file = os.path.join(input_folder, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(input_folder, "pose.txt")
        image_data = np.loadtxt(os.path.join(input_folder, "rgb.txt"), delimiter=" ", dtype=str)
        depth_data = np.loadtxt(os.path.join(input_folder, "depth.txt"), delimiter=" ",
                                dtype=str)
        pose_data = np.loadtxt(pose_file, delimiter=" ", dtype=str, skiprows=1)
        pose_vecs = pose_data.astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_vecs[:, 0]

        assoc = self._associate(t_img, t_depth, t_pose)
        keep = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / frame_rate:
                keep.append(i)

        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        for ix in keep:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(input_folder, image_data[i, 1]))
            self.depth_paths.append(os.path.join(input_folder, depth_data[j, 1]))
            T_c2w = _quat_xyzw_to_matrix(pose_vecs[k, 4:8])
            T_c2w[:3, 3] = pose_vecs[k, 1:4]
            self.poses.append(np.linalg.inv(T_c2w))
        self.n_img = len(self.color_paths)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt: float = 0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc


# body-to-cam0 extrinsic of EuRoC (the reference's dataset.py:159-166)
_EUROC_T_I_C0 = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


class EuRoCParser:
    def __init__(self, input_folder: str, start_idx: int = 0):
        self.color_paths = sorted(glob.glob(f"{input_folder}/mav0/cam0/data/*.png"))
        self.color_paths_r = sorted(glob.glob(f"{input_folder}/mav0/cam1/data/*.png"))
        assert len(self.color_paths) == len(self.color_paths_r)
        self.color_paths = self.color_paths[start_idx:]
        self.color_paths_r = self.color_paths_r[start_idx:]
        self.n_img = len(self.color_paths)

        gt_file = f"{input_folder}/mav0/state_groundtruth_estimate0/data.csv"
        with open(gt_file) as f:
            reader = csv.reader(f)
            next(reader)
            data = np.array([list(map(float, row)) for row in reader])

        ts_pose = data[:, 0]
        self.poses = []
        for i in range(self.n_img):
            color_ts = float(os.path.basename(self.color_paths[i]).split(".")[0])
            k = int(np.argmin(np.abs(ts_pose - color_ts)))
            # EuRoC stores (w, x, y, z); reorder to xyzw
            quat_wxyz = data[k, 4:8]
            T_w_i = _quat_xyzw_to_matrix(quat_wxyz[[1, 2, 3, 0]])
            T_w_i[:3, 3] = data[k, 1:4]
            T_w_c = T_w_i @ _EUROC_T_I_C0
            self.poses.append(np.linalg.inv(T_w_c))


# ---------------------------------------------------------------------------
# datasets


def _camera_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


class MonocularDataset(BaseDataset):
    """Single-camera dataset with optional depth and undistortion."""

    def __init__(self, config, device):
        super().__init__(config, device)
        calibration = config["Dataset"]["Calibration"]
        self.distorted = bool(calibration.get("distorted", False))
        self.K = _camera_matrix(self.fx, self.fy, self.cx, self.cy)
        if self.distorted:
            dist = np.array([calibration[k] for k in ("k1", "k2", "p1", "p2", "k3")])
            self.map1x, self.map1y = camera_maps.init_undistort_rectify_map(
                self.K, dist, np.eye(3), self.K, (self.width, self.height))
            self._plan = camera_maps.remap_plan(self.map1x, self.map1y, self.device)
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []

    def __getitem__(self, idx: int):
        image = self.reader.samples(self.color_paths[idx])
        if image.dim() == 2:
            image = torch.stack([image] * 3, dim=-1)
        if self.distorted:
            image = camera_maps.remap_linear(image, self._plan)
        depth = None
        if self.has_depth and idx < len(self.depth_paths):
            depth = _div(self.reader.samples(self.depth_paths[idx]).to(torch.float32),
                         self.depth_scale)
        return self._to_unit(image), depth, self.poses[idx]


class TUMDataset(MonocularDataset):
    def __init__(self, config, device):
        super().__init__(config, device)
        parser = TUMParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.poses = parser.poses


class ReplicaDataset(MonocularDataset):
    def __init__(self, config, device):
        super().__init__(config, device)
        parser = ReplicaParser(config["Dataset"]["dataset_path"])
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.depth_paths = parser.depth_paths
        self.poses = parser.poses


class StereoDataset(BaseDataset):
    """EuRoC-style stereo: rectify both eyes, semi-global matching -> depth."""

    # ORB-SLAM2 EuRoC config: baseline * fx (the reference's dataset.py:380-383)
    BASELINE_FX = 47.90639384423901

    def __init__(self, config, device):
        calibration = config["Dataset"]["Calibration"]
        # BaseDataset reads fx... from a flat Calibration dict; stereo stores
        # them per eye, so make the flat view first
        flat = dict(calibration)
        flat.update(calibration["cam0"]["opt"])
        cfg = dict(config)
        cfg["Dataset"] = dict(config["Dataset"])
        cfg["Dataset"]["Calibration"] = flat
        super().__init__(cfg, device)
        self.config = config

        cam0raw, cam1raw = calibration["cam0"]["raw"], calibration["cam1"]["raw"]
        cam1opt = calibration["cam1"]["opt"]
        K_raw = _camera_matrix(cam0raw["fx"], cam0raw["fy"], cam0raw["cx"], cam0raw["cy"])
        K_opt = _camera_matrix(self.fx, self.fy, self.cx, self.cy)
        K_raw_r = _camera_matrix(cam1raw["fx"], cam1raw["fy"], cam1raw["cx"], cam1raw["cy"])
        K_opt_r = _camera_matrix(cam1opt["fx"], cam1opt["fy"], cam1opt["cx"], cam1opt["cy"])
        R0 = np.array(calibration["cam0"]["R"]["data"]).reshape(3, 3)
        R1 = np.array(calibration["cam1"]["R"]["data"]).reshape(3, 3)
        d0 = np.array([cam0raw[k] for k in ("k1", "k2", "p1", "p2", "k3")])
        d1 = np.array([cam1raw[k] for k in ("k1", "k2", "p1", "p2", "k3")])
        size = (self.width, self.height)
        self.map1x, self.map1y = camera_maps.init_undistort_rectify_map(K_raw, d0, R0, K_opt,
                                                                        size)
        self.map1x_r, self.map1y_r = camera_maps.init_undistort_rectify_map(
            K_raw_r, d1, R1, K_opt_r, size)
        self._plan = camera_maps.remap_plan(self.map1x, self.map1y, self.device)
        self._plan_r = camera_maps.remap_plan(self.map1x_r, self.map1y_r, self.device)
        self.has_depth = True  # stereo depth is synthesized
        self.color_paths: List[str] = []
        self.color_paths_r: List[str] = []
        self.poses: List[np.ndarray] = []

    def rectified_pair(self, idx: int):
        """The two rectified uint8 (H, W) eyes of frame idx, on the device."""
        return (camera_maps.remap_linear(self.reader.gray(self.color_paths[idx]), self._plan),
                camera_maps.remap_linear(self.reader.gray(self.color_paths_r[idx]),
                                         self._plan_r))

    def __getitem__(self, idx: int):
        image, image_r = self.rectified_pair(idx)
        disparity = _div(sgbm_disparity(image, image_r).to(torch.float32), 16.0)
        disparity = torch.where(disparity == 0, 1e10, disparity)
        depth = torch.full_like(disparity, self.BASELINE_FX) / disparity
        depth = torch.where(depth < 0, 0.0, depth)
        rgb = torch.stack([image] * 3, dim=-1)
        return self._to_unit(rgb), depth, self.poses[idx]


class EurocDataset(StereoDataset):
    def __init__(self, config, device):
        super().__init__(config, device)
        parser = EuRoCParser(config["Dataset"]["dataset_path"],
                             start_idx=int(config["Dataset"].get("start_idx", 0)))
        self.num_imgs = parser.n_img
        self.color_paths = parser.color_paths
        self.color_paths_r = parser.color_paths_r
        self.poses = parser.poses


class RealsenseDataset(BaseDataset):
    """Live Realsense capture (the reference's dataset.py:429-519); needs
    pyrealsense2. Colour at 640x480/30 fps with auto exposure and auto
    white balance off and a fixed exposure; with `sensor_type: depth` the
    depth stream is aligned to the colour camera and scaled to metres by
    the device's depth scale. The colour image is undistorted with the
    device-reported coefficients (as 8-bit, before the float conversion)."""

    def __init__(self, config, device):
        try:
            import pyrealsense2 as rs
        except Exception as e:
            raise RuntimeError(
                "pyrealsense2 is not available; use type 'realsense_replay' "
                "to replay recorded frames"
            ) from e
        self.config = config
        self.device = torch.device(device)
        self.rs = rs
        ds = config["Dataset"]
        self.has_depth = ds.get("sensor_type", "monocular") == "depth"
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, 640, 480, rs.format.bgr8, 30)
        if self.has_depth:
            cfg.enable_stream(rs.stream.depth)
        profile = self.pipeline.start(cfg)
        color_sensor = profile.get_device().query_sensors()[1]
        color_sensor.set_option(rs.option.enable_auto_exposure, False)
        color_sensor.set_option(rs.option.enable_auto_white_balance, False)
        color_sensor.set_option(rs.option.exposure, float(ds.get("exposure", 200.0)))
        intr = profile.get_stream(rs.stream.color).as_video_stream_profile().get_intrinsics()
        self.fx, self.fy, self.cx, self.cy = intr.fx, intr.fy, intr.ppx, intr.ppy
        self.width, self.height = intr.width, intr.height
        self.dist_coeffs = np.asarray(intr.coeffs, np.float32)
        self._plan = None
        if np.any(self.dist_coeffs != 0.0):
            K = _camera_matrix(self.fx, self.fy, self.cx, self.cy)
            m1, m2 = camera_maps.init_undistort_rectify_map(K, self.dist_coeffs, np.eye(3), K,
                                                            (self.width, self.height))
            self._plan = camera_maps.remap_plan(m1, m2, self.device)
        if self.has_depth:
            self.align = rs.align(rs.stream.color)
            self.depth_scale = profile.get_device().first_depth_sensor().get_depth_scale()
        else:
            self.align = None
            self.depth_scale = None
        self.num_imgs = 999999

    def __getitem__(self, idx: int):
        frameset = self.pipeline.wait_for_frames()
        depth = None
        if self.has_depth:
            frameset = self.align.process(frameset)
            raw = np.asanyarray(frameset.get_depth_frame().get_data()).astype(np.float32)
            depth = torch.from_numpy(raw * np.float32(self.depth_scale)).to(self.device)
        bgr = np.asanyarray(frameset.get_color_frame().get_data())
        image = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1])).to(self.device)
        if self._plan is not None:
            image = camera_maps.remap_linear(image, self._plan)
        return self._to_unit(image), depth, np.eye(4)


class RealsenseReplayDataset(MonocularDataset):
    """Replays recorded Realsense-style frames from a directory.

    Layout: <path>/color/*.png|jpg [+ <path>/depth/*.png with depth_scale].
    GT poses are identity (live capture has none), as the reference's
    dataset.py:492.
    """

    def __init__(self, config, device):
        super().__init__(config, device)
        root = config["Dataset"]["dataset_path"]
        self.color_paths = sorted(glob.glob(os.path.join(root, "color", "*.png"))
                                  + glob.glob(os.path.join(root, "color", "*.jpg")))
        depth_dir = os.path.join(root, "depth")
        if self.has_depth and os.path.isdir(depth_dir):
            self.depth_paths = sorted(glob.glob(os.path.join(depth_dir, "*.png")))
        else:
            self.has_depth = False
        self.num_imgs = len(self.color_paths)
        self.poses = [np.eye(4) for _ in range(self.num_imgs)]


def load_dataset(config, device):
    """Factory keyed on Dataset.type (the reference's dataset.py:522-532)."""
    dtype = config["Dataset"]["type"]
    if dtype == "tum":
        return TUMDataset(config, device)
    if dtype == "replica":
        return ReplicaDataset(config, device)
    if dtype == "euroc":
        return EurocDataset(config, device)
    if dtype == "realsense":
        return RealsenseDataset(config, device)
    if dtype == "realsense_replay":
        return RealsenseReplayDataset(config, device)
    if dtype == "synthetic":
        from .synthetic import SyntheticDataset

        return SyntheticDataset(config, device)
    raise ValueError(f"Unknown dataset type: {dtype}")
