"""Build a CUDA source into a plain-C shared library and load it (ctypes).

``nvcc`` compiles each library on first use into ``build/kernels/`` at the
root of the checkout, in a directory keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
is kept beside the library in ``build.log``. A failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    log_path: Path
    build_seconds: float | None  # None when loaded from an earlier build


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_library(name: str, sources: list[Path]) -> KernelLibrary:
    """Build (once) and load ``lib<name>.so`` from ``sources``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    so = out_dir / f"lib{name}.so"
    log = out_dir / "build.log"
    seconds = None
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {res.returncode}:\n{res.stdout}{res.stderr}"
            )
        log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        os.replace(tmp, so)
    return KernelLibrary(ctypes.CDLL(str(so)), so, log, seconds)
