"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
harness, the cells' configurations, traffic mixes, limits and per-layer
metrics, and the plain reference.  ``python3 bench/run.py --help``."""
