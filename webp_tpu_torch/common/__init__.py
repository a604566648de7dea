"""Spec tables of the VP8 format, copied jax-free from the JAX package."""
