"""The benchmark of the PyTorch/CUDA port: `python -m auction_bench.run`."""
