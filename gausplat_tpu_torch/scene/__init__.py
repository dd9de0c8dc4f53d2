"""The 3DGS scene, the point cloud, the PLY codec and the COLMAP loader."""
