"""Build a CUDA source into a plain-C shared library and load it (ctypes).

``nvcc`` compiles each library on first use into ``build/kernels/`` at the
root of the checkout, in a directory keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
is kept beside the library in ``build.log``. A failed build raises.
:func:`build_libraries` starts one ``nvcc`` per library at once, so a
run that needs several families pays for the slowest build only.
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
    build_seconds: float | None  # None when built by an earlier process


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _paths(name: str, sources: list[Path]) -> tuple[Path, Path, Path]:
    """(output dir, library, build log) for ``name`` built from ``sources``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    return out_dir, out_dir / f"lib{name}.so", out_dir / "build.log"


_BUILD_SECONDS: dict[str, float] = {}


def build_libraries(specs: dict[str, list[Path]]) -> None:
    """Build every library of ``specs`` ({name: sources}) that is not built
    yet, one ``nvcc`` per library, all started together. Raises on the
    first failure, after every compiler has ended."""
    running = []
    for name, sources in specs.items():
        out_dir, so, log = _paths(name, sources)
        if so.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((name, cmd, proc, tmp, so, log, time.perf_counter()))
    failed = []
    for name, cmd, proc, tmp, so, log, t0 in running:
        out, _ = proc.communicate()
        _BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed with code {proc.returncode}:\n{out}")
            continue
        log.write_text(" ".join(cmd) + "\n" + out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, sources: list[Path]) -> KernelLibrary:
    """Build (once, unless :func:`build_libraries` already did) and load
    ``lib<name>.so`` from ``sources``."""
    _, so, log = _paths(name, sources)
    if not so.exists():
        build_libraries({name: sources})
    return KernelLibrary(ctypes.CDLL(str(so)), so, log, _BUILD_SECONDS.get(name))
