"""The 3DGS scene and its PLY codec."""
