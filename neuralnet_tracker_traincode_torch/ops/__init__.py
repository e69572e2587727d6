"""Tensor math: quaternions, 2D affine transforms, rotation representations."""
