"""Render a .3dgs.ply scene to a PNG from the command line.

The counterpart of ``scripts/render_ply.py``: decode a 3DGS PLY
(:mod:`gausplat_tpu_torch.scene.ply`), place an orbit camera, render
(:func:`gausplat_tpu_torch.render`), and write an 8-bit RGB PNG (with the
standard library: ``zlib`` and ``struct``, no imaging package). It renders
on the CUDA card unless ``--device cpu`` is given:

    python -m gausplat_tpu_torch.scripts.render_ply scene.3dgs.ply out.png \\
        [--width 1280] [--height 720] [--fov 1.0] [--radius 4.0] \\
        [--azimuth 0.0] [--elevation 0.0] [--sh-degree 3] [--device cuda]

The camera orbits the scene centroid at ``radius`` times the cloud's
bounding radius; azimuth and elevation in radians. Where the scene's
(tile, point) entries overflow the default buffer, the view is rendered
again with a buffer that holds them.
"""

from __future__ import annotations

import argparse
import pathlib
import struct
import sys
import zlib

import numpy as np
import torch

from ..render.pipeline import RenderOptions, _capacity, render
from ..render.view import View
from ..scene.ply import decode_polygon

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def orbit_view(positions, width: int, height: int, fov: float = 1.0, radius: float = 4.0,
               azimuth: float = 0.0, elevation: float = 0.0) -> View:
    """A camera on the sphere of ``radius`` times the cloud's bounding radius
    around its centroid, at ``azimuth`` / ``elevation`` (radians), looking
    at the centroid (-z forward), ``fov`` across. ``positions`` is the
    float32 ``[P, 3]`` array of the scene's positions."""
    pos = np.asarray(positions)
    center = pos.mean(axis=0)
    bound = float(np.linalg.norm(pos - center, axis=1).max()) or 1.0

    az, el = azimuth, elevation
    eye = center + radius * bound * np.array(
        [np.cos(el) * np.sin(az), np.sin(el), -np.cos(el) * np.cos(az)]
    )
    fwd = center - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    rot = np.stack([right, up, fwd])  # world -> camera rows

    fov_y = 2.0 * np.arctan(np.tan(fov / 2.0) * height / width)
    return View(
        field_of_view_x=fov,
        field_of_view_y=float(fov_y),
        image_height=height,
        image_width=width,
        view_position=[float(x) for x in eye],
        view_transform=View.transform(rot, -rot @ eye),
    )


def to_u8(image: torch.Tensor) -> np.ndarray:
    """``[H, W, 3]`` colours in [0, 1] -> u8, rounded as the JAX CLI does."""
    img = image.detach().to("cpu", torch.float32).numpy()
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img8: np.ndarray) -> bytes:
    """An 8-bit RGB ``[H, W, 3]`` array as PNG bytes: the signature, IHDR,
    one IDAT of filter-0 rows, IEND."""
    height, width, channels = img8.shape
    if channels != 3 or img8.dtype != np.uint8:
        raise ValueError(f"expected u8 [H, W, 3], got {img8.dtype} {img8.shape}")
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), img8.reshape(height, width * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as :func:`encode_png` writes them (8-bit RGB, not
    interlaced, filter-0 rows) -> u8 ``[H, W, 3]``; anything else raises
    ``ValueError``."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    at, idat, header = 8, [], None
    while at < len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + length]
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        at += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG without interlace: IHDR {header}")
    width, height = header[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, width * 3 + 1)
    if raw[:, 0].any():
        raise ValueError("row filters other than 0 are not read")
    return raw[:, 1:].reshape(height, width, 3).copy()


def render_ply(ply: pathlib.Path, out: pathlib.Path, *, width=1280, height=720, fov=1.0,
               radius=4.0, azimuth=0.0, elevation=0.0, sh_degree=3, device="cuda",
               log=print) -> np.ndarray:
    """Decode ``ply`` on ``device``, render the orbit view, write the PNG to
    ``out``; returns the u8 image."""
    scene = decode_polygon(pathlib.Path(ply).read_bytes(), device=device)
    view = orbit_view(scene.positions.detach().cpu().numpy(), width, height, fov, radius,
                      azimuth, elevation)
    options = RenderOptions(colors_sh_degree_max=sh_degree)
    with torch.no_grad():
        result = render(scene, view, options)
        total = int(result.tile_point_total)
        capacity = _capacity(scene.point_count, options)
        if total > capacity:
            log(f"{total} entries overflow the buffer of {capacity}; rendering again")
            options = RenderOptions(colors_sh_degree_max=sh_degree, tile_entry_capacity=total)
            result = render(scene, view, options)
    img8 = to_u8(result.colors_rgb_2d)
    pathlib.Path(out).write_bytes(encode_png(img8))
    log(f"rendered {scene.point_count} points -> {out} "
        f"({width}x{height}, sh degree {sh_degree})")
    return img8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ply", type=pathlib.Path)
    ap.add_argument("out", type=pathlib.Path)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fov", type=float, default=1.0, help="horizontal fov, radians")
    ap.add_argument("--radius", type=float, default=4.0,
                    help="orbit radius in units of the cloud bounding radius")
    ap.add_argument("--azimuth", type=float, default=0.0)
    ap.add_argument("--elevation", type=float, default=0.0)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    render_ply(args.ply, args.out, width=args.width, height=args.height, fov=args.fov,
               radius=args.radius, azimuth=args.azimuth, elevation=args.elevation,
               sh_degree=args.sh_degree, device=args.device)


if __name__ == "__main__":
    main()
