"""Batched lossy VP8 decode on a torch device."""
