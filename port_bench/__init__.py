"""The benchmark of the PyTorch/CUDA port (`python port_bench/run.py`)."""
