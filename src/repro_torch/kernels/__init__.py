"""The port's kernels: hand-written CUDA C++ (``csrc/``) behind thin
PyTorch wrappers, each beside its plain PyTorch version (``ref.py``)."""
