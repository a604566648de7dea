"""The benchmark harness of the PyTorch and CUDA port (`webp_tpu_torch`).

`spec` resolves a workload of `BENCHMARK.json` to its configuration
(`configs/`), traffic mix (`traffic/`), metrics and their readers
(`metrics/`); the mix's "runner" names the module here that runs it
(`encode_pipeline`, `decode_pipeline`).  The yardstick lives here and in
`vp8ref/`: the inputs from the seed (`synthetic_rgb`, `random_vp8`), the
pipeline loops (`lane`), the trace reduction (`trace`), the peaks and the
work counts (`roofline`), and the plain reference that decides `correct`.
"""
