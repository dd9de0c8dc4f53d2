"""Error types.

The same surface as ``gausplat_tpu/errors.py`` (which mirrors the
reference's src/error/mod.rs:9-40), plus the one error of the port's own:
a hand-written kernel that did not build or launch.
"""

from .constants import SH_DEGREE_MAX


class GausplatError(Exception):
    """Base class for all gausplat_tpu_torch errors."""


class IoError(GausplatError):
    """File-system level failure (reference Error::Io, error/mod.rs:15-16).

    Wraps the underlying ``OSError`` so callers can catch every gausplat
    failure mode through :class:`GausplatError`.
    """

    def __init__(self, cause: OSError):
        self.cause = cause
        super().__init__(f"Io error: {cause}")


class LoaderError(GausplatError):
    """Malformed input data (reference Error::Loader, error/mod.rs:18-19)."""

    def __init__(self, message: str):
        super().__init__(f"Loader error: {message}")


class InvalidPixelCountError(GausplatError):
    def __init__(self, pixel_count: int):
        self.pixel_count = pixel_count
        super().__init__(
            f"Invalid pixel count: {pixel_count}. "
            "It should not be zero or excessively large."
        )


class MismatchedPolygonHeaderError(GausplatError):
    def __init__(self, header: str):
        self.header = header
        super().__init__(
            "Mismatched polygon header (3DGS PLY). "
            f"Please check the file again:\n--------\n{header}--------\n"
        )


class MismatchedPointCountError(GausplatError):
    def __init__(self, got, expected):
        super().__init__(f"Mismatched point count: {got}. It should be {expected}.")


class MismatchedTensorShapeError(GausplatError):
    def __init__(self, got, expected):
        super().__init__(f"Mismatched tensor shape: {got}. It should be {expected}.")


class UnsupportedSphericalHarmonicsDegreeError(GausplatError):
    def __init__(self, degree: int):
        super().__init__(
            f"Unsupported spherical harmonics degree: {degree}. "
            f"It should be no more than {SH_DEGREE_MAX}."
        )


class KernelError(GausplatError):
    """A hand-written CUDA kernel failed to build, load or launch."""
