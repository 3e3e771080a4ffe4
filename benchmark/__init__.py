"""The benchmark of the PyTorch/CUDA port (``sonet_torch``): one command,
``python3 benchmark/run.py``, runs one cell of ``BENCHMARK.json``.  See
``benchmark/README.md``."""
