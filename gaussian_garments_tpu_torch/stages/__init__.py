"""Offline stage pipelines: stage 1's dataset export, COLMAP chain,
meshing and segmentation (``s1``, ``meshing``)."""
