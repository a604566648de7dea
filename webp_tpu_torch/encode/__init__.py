"""Host half and orchestration of the batched lossy VP8 encode."""
