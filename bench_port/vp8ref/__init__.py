"""The benchmark's plain reference of the lossy VP8 codec.

`encoder.encode_frames` re-encodes RGB frames the way the port's two-pass
batch encode does (K8's alphas and the k-means segments, pass 1, the
adapted probabilities and their rate tables, pass 2 with the trellis, the
host finisher), with frozen copies of the port's plain torch code and
Python coders; `test_bench_runs.py` holds it byte-equal to the JAX
package's lossy batch encode on the CPU, the witness that does not descend
from the port.  `decoder.decode_rgb` decodes a VP8 keyframe with a frozen
copy of the JAX package's numpy decoder.  Nothing here imports the port,
the JAX package or jax.
"""
