"""3DGS PLY codec (checkpoint / interchange format), numpy underneath.

Counterpart of ``gausplat_tpu/scene/ply.py`` without its optional C++
codec. Reference: src/scene/gaussian_3d/header.3dgs.ply (canonical
header), import.rs:15-89 (decode), export.rs:11-71 (encode).

Layout per vertex (62 float32 properties)::

    x y z | nx ny nz | f_dc_0..2 | f_rest_0..44 | opacity | scale_0..2 | rot_0..3

``f_rest`` is stored channel-major on disk ([3, 15]) while the scene tensor is
coefficient-major ([15, 3] within [P, 16, 3] flattened). ``rot`` is stored
scalar-first (w, x, y, z) on disk; the scene tensor is scalar-last.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Union

import numpy as np
import torch

from ..constants import SH_COUNT_MAX
from ..errors import IoError, MismatchedPolygonHeaderError
from .gaussian_3d import GaussianScene

PROPERTY_COUNT = 62

#: Property names in canonical order.
PROPERTY_NAMES = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + [f"f_rest_{i}" for i in range(45)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def _header_text(point_count: int) -> str:
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {point_count}",
    ]
    lines += [f"property float {name}" for name in PROPERTY_NAMES]
    lines.append("end_header")
    return "\n".join(lines) + "\n"


def _parse_header(reader: BinaryIO) -> tuple[int, str]:
    """Parse and validate a 3DGS PLY header; return (point_count, fmt)."""
    raw_lines = []
    while True:
        try:
            line = reader.readline()
        except OSError as e:
            raise IoError(e) from e
        if not line:
            raise MismatchedPolygonHeaderError("".join(raw_lines))
        text = line.decode("ascii", errors="replace").rstrip("\r\n")
        raw_lines.append(text + "\n")
        if text == "end_header":
            break
        if len(raw_lines) > 4096:
            raise MismatchedPolygonHeaderError("".join(raw_lines[:64]))

    header = "".join(raw_lines)

    # Strict order check against the canonical 3DGS layout (comments ignored),
    # matching Header::is_same_order in the reference (import.rs:22-24).
    fmt = None
    point_count = None
    elements = []  # (name, [property names]) in order
    for text in raw_lines:
        parts = text.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1] if len(parts) > 1 else None
        elif parts[0] == "element" and len(parts) == 3:
            elements.append((parts[1], []))
            if parts[1] == "vertex":
                point_count = int(parts[2])
        elif parts[0] == "property" and elements:
            if len(parts) == 3 and parts[1] == "float":
                elements[-1][1].append(parts[2])
            else:
                raise MismatchedPolygonHeaderError(header)

    if (
        fmt not in ("binary_little_endian", "binary_big_endian")
        or point_count is None
        or point_count < 0
        or [name for name, _ in elements] != ["vertex"]
        or elements[0][1] != PROPERTY_NAMES
    ):
        raise MismatchedPolygonHeaderError(header)
    return point_count, fmt


def decode_polygon(source: Union[bytes, BinaryIO], *, device) -> GaussianScene:
    """Decode a 3DGS PLY file into a :class:`GaussianScene` on ``device``."""
    reader = io.BytesIO(source) if isinstance(source, (bytes, bytearray)) else source
    point_count, fmt = _parse_header(reader)

    dtype = "<f4" if fmt == "binary_little_endian" else ">f4"
    try:
        payload = reader.read(point_count * PROPERTY_COUNT * 4)
    except OSError as e:
        raise IoError(e) from e
    if len(payload) != point_count * PROPERTY_COUNT * 4:
        raise MismatchedPolygonHeaderError(
            f"payload holds {len(payload)} bytes; header declares "
            f"{point_count} vertices ({point_count * PROPERTY_COUNT * 4} bytes)"
        )

    data = np.frombuffer(payload, dtype=dtype, count=point_count * PROPERTY_COUNT)
    data = data.astype(np.float32).reshape(point_count, PROPERTY_COUNT)

    f_rest = data[:, 9:54].reshape(point_count, 3, SH_COUNT_MAX - 1)
    # [P, M, 3]: DC at m=0; rest transposed channel-major -> coefficient-major.
    colors_sh = np.empty((point_count, SH_COUNT_MAX, 3), np.float32)
    colors_sh[:, 0, :] = data[:, 6:9]
    colors_sh[:, 1:, :] = np.transpose(f_rest, (0, 2, 1))

    return GaussianScene.from_numpy(
        colors_sh=colors_sh.reshape(point_count, SH_COUNT_MAX * 3),
        opacities=data[:, 54:55],
        positions=data[:, 0:3],
        rotations=data[:, 58:62][:, [1, 2, 3, 0]],  # wxyz -> xyzw
        scalings=data[:, 55:58],
        device=device,
    )


def encode_polygon(scene: GaussianScene, writer: BinaryIO | None = None) -> bytes:
    """Encode a :class:`GaussianScene` as a 3DGS PLY file (little-endian)."""
    point_count = scene.point_count

    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    colors_sh = host(scene.colors_sh)
    f_rest = (
        colors_sh[:, 3:]
        .reshape(point_count, SH_COUNT_MAX - 1, 3)
        .transpose(0, 2, 1)
        .reshape(point_count, 3 * (SH_COUNT_MAX - 1))
    )

    data = np.empty((point_count, PROPERTY_COUNT), np.float32)
    data[:, 0:3] = host(scene.positions)
    data[:, 3:6] = 0.0  # unused normals
    data[:, 6:9] = colors_sh[:, 0:3]
    data[:, 9:54] = f_rest
    data[:, 54:55] = host(scene.opacities)
    data[:, 55:58] = host(scene.scalings)
    data[:, 58:62] = host(scene.rotations)[:, [3, 0, 1, 2]]

    out = _header_text(point_count).encode("ascii") + data.astype("<f4").tobytes()
    if writer is not None:
        try:
            writer.write(out)
        except OSError as e:
            raise IoError(e) from e
    return out
