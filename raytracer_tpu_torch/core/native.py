"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into a shared library at first use, then loaded with
``ctypes``: a build of a few seconds, with no PyTorch headers in it.  The
library lands in ``build/<name>-<hash>/`` at the repository root, named by
a hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source builds anew and an unchanged one is reused.  Without
``nvcc`` this raises.
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
from typing import Dict

PACKAGE = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build"

# -fmad=false: every multiply and add rounds on its own, as the plain
# PyTorch version's separate operations do, so the two agree bit for bit.
# No --use_fast_math: sqrt, division and acos/sin/cos stay IEEE / precise.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class NativeLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_log: str        # nvcc's output, with ptxas' register/spill lines
    build_seconds: float  # 0.0 when an earlier build was reused


_LOADED: Dict[str, NativeLibrary] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def load(name: str) -> NativeLibrary:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    if name in _LOADED:
        return _LOADED[name]
    src = SRC_DIR / f"{name}.cu"
    # The shared headers are hashed too, so an edited header builds anew.
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{digest}"
    out = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not out.exists():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)          # atomic: concurrent builders agree
    log = log_path.read_text() if log_path.exists() else ""
    lib = NativeLibrary(name, ctypes.CDLL(str(out)), out, log, seconds)
    _LOADED[name] = lib
    return lib
