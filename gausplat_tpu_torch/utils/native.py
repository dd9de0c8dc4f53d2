"""The host C++ PLY payload codec, built at first use and loaded with ctypes.

Counterpart of ``gausplat_tpu/utils/native.py``. The source is
``gausplat_tpu_torch/csrc/ply_codec.cpp`` (a plain C interface, no
``Python.h``). At its first use it is compiled with the host C++ compiler
(``$CXX``, else ``g++``, else ``c++``) into ``build/gausplat_tpu_torch/``
under a hash of the source and the flags, through the kernels' build and
cache (:func:`~gausplat_tpu_torch.utils.kernels.load_library`).

:func:`available` says whether a compiler is there. Without one, the
callers in :mod:`gausplat_tpu_torch.scene.ply` take their numpy path, as
the JAX package does without its extension; the results are identical.
With one, a build or load that fails raises
:class:`~gausplat_tpu_torch.errors.KernelError`: nothing falls back
quietly.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from ..errors import KernelError
from .kernels import CSRC_DIR, I64, PTR, load_library

PROPERTY_COUNT = 62
#: Floats per point of colors_sh, opacities, positions, rotations, scalings.
WIDTHS = (48, 1, 3, 4, 3)

SOURCE = CSRC_DIR / "ply_codec.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def find_cxx() -> str | None:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++`` on PATH."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def available() -> bool:
    """Whether the codec can be built here (a host C++ compiler is found)."""
    return find_cxx() is not None


def _library():
    def compiler():
        found = find_cxx()
        if found is None:
            raise KernelError("no host C++ compiler ($CXX, g++ or c++) on PATH")
        return found

    lib, _ = load_library(SOURCE, CXX_FLAGS, compiler, header_glob=None)
    lib.gs_ply_decode.argtypes = [PTR, I64, I64, PTR, PTR, PTR, PTR, PTR, PTR]
    lib.gs_ply_encode.argtypes = [PTR, PTR, PTR, PTR, PTR, PTR, I64, PTR, I64]
    lib.gs_ply_decode.restype = lib.gs_ply_encode.restype = ctypes.c_int
    return lib


def _lengths(arrays) -> np.ndarray:
    return np.array([a.size for a in arrays], np.int64)


def decode_payload(payload: bytes, point_count: int):
    """Payload bytes -> (colors_sh, opacities, positions, rotations,
    scalings) float32 arrays. Raises ``ValueError`` when the payload is too
    short for ``point_count`` points."""
    data = np.frombuffer(payload, np.uint8)
    out = tuple(np.empty((point_count, w), np.float32) for w in WIDTHS)
    lens = _lengths(out)
    code = _library().gs_ply_decode(
        data.ctypes.data, data.size // 4, point_count, *(a.ctypes.data for a in out),
        lens.ctypes.data,
    )
    if code != 0:
        raise ValueError("buffer sizes do not match point count")
    return out


def encode_payload(colors_sh, opacities, positions, rotations, scalings) -> bytes:
    """Five float32 arrays -> interleaved payload bytes. Raises
    ``ValueError`` when an array is too small for ``colors_sh``'s point
    count."""
    arrays = tuple(np.ascontiguousarray(a, np.float32)
                   for a in (colors_sh, opacities, positions, rotations, scalings))
    point_count = arrays[0].shape[0]
    out = np.empty((point_count, PROPERTY_COUNT), np.float32)
    lens = _lengths(arrays)
    code = _library().gs_ply_encode(
        *(a.ctypes.data for a in arrays), lens.ctypes.data, point_count,
        out.ctypes.data, out.size,
    )
    if code != 0:
        raise ValueError("buffer sizes do not match point count")
    return out.tobytes()
