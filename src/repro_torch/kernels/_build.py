"""Build the port's CUDA kernels and bind them through ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into ONE shared library,
``build/repro_torch_kernels/<hash>/libkernels.so`` at the checkout's root,
where ``<hash>`` digests the sources, the headers they include
(``csrc/*.cuh``) and the flags: an edited source or header builds anew,
an unchanged one is loaded as it is.  The library has a plain C
interface — each entry point takes pointers, sizes and the stream,
launches on that stream and returns ``cudaGetLastError()`` — so no
PyTorch header is compiled.  It links no ``libcuda``: the one driver
function it needs, ``cuTensorMapEncodeTiled`` (TMA descriptors), comes
from ``cudaGetDriverEntryPoint`` at run time (``csrc/sm90.cuh``), so the
build needs only the toolkit.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

_HERE = Path(__file__).resolve()
CSRC = _HERE.parents[1] / "csrc"
BUILD_ROOT = _HERE.parents[3] / "build" / "repro_torch_kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_longlong, ctypes.c_float)
# C entry points and their argument types: c_void_p for every pointer
# and the stream, so ctypes never truncates one to a 32-bit int
SIGNATURES: dict[str, list] = {
    # x, n, dtype, op, WG, TS, partials, ticket, out, stream
    "tr_reduce": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P],
    # wg, ts, out, n, size, NP, GMT, L, U, warp, (m, s) of NP, U and warp,
    # threads, ept, stream
    "se_sweep_eval": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _U, _U, _U,
                      _U, _U, _U, _I, _I, _P],
    # a, b, c, M, N, K, dtype, bm, bn, bk, stream
    "mm_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, BH, S, D, dtype, causal, has_window, window, scale,
    # bq, bk, stream
    "fa_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                   _P],
}


@dataclass
class BuildInfo:
    path: Path
    built: bool                 # False: an earlier build was loaded
    seconds: float = 0.0        # wall time of the nvcc processes
    ptxas: dict[str, list[str]] = field(default_factory=dict)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    """Digest of the flags and of every ``*.cu`` and ``*.cuh`` in
    ``csrc``: a header edit must not reuse a library built before it."""

    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        p = Path(root) / "bin" / "nvcc"
        if root and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _ptxas_lines(log: str) -> list[str]:
    """Per kernel: its entry, registers, shared memory and spills, and
    any ptxas warning (e.g. wgmma serialised, setmaxnreg ignored)."""

    keep = ("Compiling entry", "registers", "smem", "warning",
            "Performance")
    return [ln.strip() for ln in log.splitlines()
            if ("ptxas" in ln and any(k in ln for k in keep))
            or "spill" in ln]


def ptxas_usage(lines: list[str]) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel entry in ``lines`` (one
    source file's ptxas lines, as :class:`BuildInfo` keeps them)."""

    usage: dict[str, dict[str, int]] = {}
    entry = None
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            usage[entry] = {}
        elif entry is None:
            continue
        elif "spill stores" in ln:
            words = ln.replace(",", " ").split()
            usage[entry]["spill_stores"] = int(
                words[words.index("stores") - 3])
            usage[entry]["spill_loads"] = int(words[words.index("loads") - 3])
        elif "Used" in ln and "registers" in ln:
            words = ln.split()
            usage[entry]["registers"] = int(words[words.index("Used") + 1])
    return usage


def sass(path: Path) -> dict[str, list[str]]:
    """Each kernel's SASS instructions in the library at ``path``, from
    ``cuobjdump -sass`` (predicates kept, operands' spacing squeezed)."""

    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    fn = None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        instr = re.search(r"\*/\s*(.*?)\s*;", ln)
        if fn is not None and instr is not None:
            out[fn].append(re.sub(r"\s+", " ", instr.group(1)))
    return out


def build() -> BuildInfo:
    """Compile and link ``libkernels.so`` unless this source hash already
    has one; raises ``RuntimeError`` with nvcc's output on failure."""

    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "libkernels.so"
    logfile = out_dir / "ptxas.log"
    if so.is_file():
        ptxas = {}
        if logfile.is_file():
            for ln in logfile.read_text().splitlines():
                name, _, line = ln.partition("\t")
                ptxas.setdefault(name, []).append(line)
        return BuildInfo(path=so, built=False, ptxas=ptxas)

    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir, prefix="tmp"))
    try:
        t0 = time.perf_counter()
        srcs = _sources()
        procs = [(src, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in srcs]
        ptxas: dict[str, list[str]] = {}
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            ptxas[src.name] = _ptxas_lines(log)
            if proc.returncode != 0:
                failed.append(f"--- {src.name} (rc={proc.returncode})\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o",
             str(tmp / "libkernels.so"),
             *(str(tmp / (s.stem + ".o")) for s in srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        seconds = time.perf_counter() - t0
        (tmp / "ptxas.log").write_text("".join(
            f"{name}\t{line}\n" for name, lines in ptxas.items()
            for line in lines))
        os.replace(tmp / "ptxas.log", logfile)
        os.replace(tmp / "libkernels.so", so)     # atomic: last one wins
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(path=so, built=True, seconds=seconds, ptxas=ptxas)


class _Library:
    """The loaded library and how it came to be; built at first use."""

    def __init__(self):
        self._lib: ctypes.CDLL | None = None
        self.info: BuildInfo | None = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                info = build()
                lib = ctypes.CDLL(str(info.path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib, self.info = lib, info
            return self._lib


_LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded at first use."""

    return _LIBRARY.get()


def build_info() -> BuildInfo | None:
    """How this process got its library (None before first use)."""

    return _LIBRARY.info


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""

    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"(cudaGetLastError after the launch)")


__all__ = ["build", "library", "build_info", "check", "source_hash",
           "ptxas_usage", "sass", "BuildInfo", "SIGNATURES"]
