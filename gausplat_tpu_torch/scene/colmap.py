"""COLMAP binary model ingestion (numpy and ``struct`` only).

Counterpart of ``gausplat_tpu/scene/colmap.py``, with the port's ``View``,
``Points`` and errors: parse ``cameras.bin`` / ``images.bin`` /
``points3D.bin`` into :class:`~gausplat_tpu_torch.scene.point.Points` and
:class:`~gausplat_tpu_torch.render.view.View` objects, ready for
``GaussianScene.from_points`` and rendering. The reference delegates this
to its sibling ``gausplat-loader`` crate (scene/point/mod.rs:17-41). As in
the JAX package, the per-point reader is a Python loop (seconds at a
million points).

Format reference: the COLMAP sparse-model binary layout (little-endian).
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import BinaryIO, Dict, Tuple

import numpy as np

from ..errors import IoError, LoaderError
from ..render.view import View, Views
from .point import Points

#: COLMAP camera models: model_id -> (name, parameter count).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def focal_lengths(self) -> Tuple[float, float]:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])


def _read(fh: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = fh.read(size)
    if len(data) != size:
        raise LoaderError("truncated COLMAP binary file")
    return struct.unpack(fmt, data)


def read_cameras_bin(fh: BinaryIO) -> Dict[int, ColmapCamera]:
    (count,) = _read(fh, "<Q")
    cameras: Dict[int, ColmapCamera] = {}
    for _ in range(count):
        camera_id, model_id, width, height = _read(fh, "<iiQQ")
        if model_id not in CAMERA_MODELS:
            raise LoaderError(f"unknown COLMAP camera model id {model_id}")
        name, num_params = CAMERA_MODELS[model_id]
        params = np.array(_read(fh, f"<{num_params}d"))
        cameras[camera_id] = ColmapCamera(
            camera_id=camera_id, model=name, width=int(width),
            height=int(height), params=params,
        )
    return cameras


def _quat_wxyz_to_rotation(qw, qx, qy, qz) -> np.ndarray:
    """COLMAP scalar-first quaternion -> world-to-camera rotation matrix."""
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def read_images_bin(
    fh: BinaryIO,
    cameras: Dict[int, ColmapCamera],
    image_names: Dict[int, str] | None = None,
) -> Views:
    """Parse images.bin into Views (keyed by image id). If ``image_names``
    is given, it is filled with image id -> registered file name (needed to
    pair views with their captured images when training)."""
    (count,) = _read(fh, "<Q")
    views: Views = {}
    for _ in range(count):
        (image_id,) = _read(fh, "<I")
        qw, qx, qy, qz, tx, ty, tz = _read(fh, "<7d")
        (camera_id,) = _read(fh, "<I")
        name = bytearray()
        while True:
            c = fh.read(1)
            if not c or c == b"\x00":
                break
            name += c
        (num_points,) = _read(fh, "<Q")
        fh.seek(num_points * 24, os.SEEK_CUR)  # skip (x f64, y f64, id i64)
        if image_names is not None:
            image_names[image_id] = name.decode("utf-8", "replace")

        if camera_id not in cameras:
            raise LoaderError(
                f"image {image_id} references unknown camera id {camera_id}"
            )
        cam = cameras[camera_id]
        fx, fy = cam.focal_lengths()
        rotation = _quat_wxyz_to_rotation(qw, qx, qy, qz)  # world -> view
        translation = np.array([tx, ty, tz])
        views[image_id] = View(
            field_of_view_x=2.0 * math.atan(cam.width / (2.0 * fx)),
            field_of_view_y=2.0 * math.atan(cam.height / (2.0 * fy)),
            image_height=cam.height,
            image_width=cam.width,
            view_id=image_id,
            view_position=-rotation.T @ translation,
            # View.transform takes the rotation column-major (M[col][row]).
            view_transform=View.transform(rotation.T, translation),
        )
    return views


def read_points3d_bin(fh: BinaryIO) -> Points:
    (count,) = _read(fh, "<Q")
    positions = np.empty((count, 3), np.float64)
    colors = np.empty((count, 3), np.uint8)
    for i in range(count):
        _point_id = _read(fh, "<Q")
        positions[i] = _read(fh, "<3d")
        colors[i] = _read(fh, "<3B")
        _error = _read(fh, "<d")
        (track_len,) = _read(fh, "<Q")
        fh.seek(track_len * 8, os.SEEK_CUR)  # skip (image_id, point2d_idx)
    return Points.from_colmap(colors, positions)


def load_sparse_model(
    model_dir: str, image_names: Dict[int, str] | None = None
) -> tuple[Points, Views]:
    """Load a COLMAP sparse model directory (cameras/images/points3D.bin).

    Raises :class:`~gausplat_tpu_torch.errors.IoError` on file-system failures
    and :class:`~gausplat_tpu_torch.errors.LoaderError` on malformed payloads,
    matching
    the reference error surface (error/mod.rs:15-19).
    """
    try:
        with open(os.path.join(model_dir, "cameras.bin"), "rb") as fh:
            cameras = read_cameras_bin(fh)
        with open(os.path.join(model_dir, "images.bin"), "rb") as fh:
            views = read_images_bin(fh, cameras, image_names)
        with open(os.path.join(model_dir, "points3D.bin"), "rb") as fh:
            points = read_points3d_bin(fh)
    except OSError as e:
        raise IoError(e) from e
    return points, views
