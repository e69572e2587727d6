"""Pose network, its heads and the weight bridge from the JAX package."""
