"""The aten matrix products' (``mm``, ``addmm``, ``bmm``, ``baddbmm``:
cuBLAS) share of their roofline in the profiled slice: Σ each op's
least time (its FLOPs over its dtype's peak, or its bytes over the HBM
bandwidth, the larger) ÷ Σ its device time."""

from bench.flops import matmul_roofline

LAYER = "kernels (cuBLAS and aten matrix products)"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(run):
    if run.slice is None or run.slice.busy_s is None:
        return None
    return matmul_roofline(run.slice.matmuls, run.info.get("tf32", False))
