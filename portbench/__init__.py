"""portbench: the benchmark of the PyTorch and CUDA port,
stringsext_tpu_torch. `python3 portbench/run.py --help`."""
