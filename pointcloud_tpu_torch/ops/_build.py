"""Build the port's CUDA sources and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library under `build/` at the root of the checkout (the
`csrc/*.cuh` headers are included, not built on their own):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the headers and the flags, so an
edited source is rebuilt and an unchanged one is reused. `build()` starts one `nvcc` per
missing library, all at once, and waits for them together; `ptxas_report`
reads each kernel's registers and spills from the output of the build that
made its library. Nothing here runs
at import: the CPU tests import every module, and this machine may have no
CUDA toolkit at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

from pointcloud_tpu_torch.utils.profiling import count, span

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}  # nvcc's output of the builds this process made


def sources() -> list[str]:
    """Names of every kernel source in csrc/ (without the .cu suffix)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    # PyTorch's CUDA_HOME: $CUDA_HOME or $CUDA_PATH, else nvcc on PATH, else
    # /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source on first use"
        )
    return str(nvcc)


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's hash
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> float:
    """Compile the named sources (default: all) that have no library yet.

    Returns the wall seconds spent; raises with nvcc's output on failure.
    """
    names = sources() if names is None else names
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with span("setup.kernels"):
        procs = []
        for name in todo:
            out = library_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in procs:
            log, _ = proc.communicate()
            _logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a concurrent build never sees half
        count("kernels_built", len(todo) - len(failed))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            with span("setup.kernels"):
                lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, spill store bytes, spill load bytes)
    of each kernel of csrc/<name>.cu, from ptxas's report of the build this
    process made (empty if the library was reused)."""
    rows, kernel, spills = [], None, (0, 0)
    for line in _logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            rows.append((kernel, int(m.group(1)), *spills))
            kernel = None
    return rows
