"""The 3DGS scene, the point cloud, the PLY codec and the COLMAP loader."""

from .gaussian_3d import GaussianScene
from .point import Points
from .ply import decode_polygon, encode_polygon

__all__ = ["GaussianScene", "Points", "decode_polygon", "encode_polygon"]
