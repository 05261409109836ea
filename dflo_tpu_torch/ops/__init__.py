"""Operator builders, contractions and the CUDA kernel wrappers."""
