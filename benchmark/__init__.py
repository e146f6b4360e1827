"""The benchmark of the PyTorch and CUDA port: `python -m benchmark.run`."""
