"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The paper's tuning loop (Tunable → engine → cache → ``@autotune``) in
plain PyTorch, with the kernels on its path written by hand in CUDA C++
(``csrc/``) and bound through ``ctypes``.  Entry points run on ``cuda:0``
unless given CPU tensors or ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.
"""

__version__ = "1.0.0"
