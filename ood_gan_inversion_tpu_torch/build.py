"""Builds the hand-written CUDA kernels in `csrc/` and loads them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
sm_90a into `build/ogi_torch_kernels/lib<name>-<hash>.so` at the root of the
checkout, then loaded with ctypes. The hash covers the source, every shared
header `csrc/*.cuh` and the compiler flags, so an edited kernel or header is
rebuilt. The build happens at the first launch on a CUDA tensor;
`build_all()` compiles several sources at once, one nvcc each, started
together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ogi_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Starts nvcc for one source unless its library exists; returns
    (process or None, target path, temporary path)."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def build_all(names) -> dict[str, str]:
    """Compiles every named source that is not built yet, all nvcc processes
    at once. Returns each name's compiler output ('' if it was built
    already); raises if any build fails."""
    started = {n: _start(n) for n in names}
    logs, failed = {}, []
    for n, (proc, out, tmp) in started.items():
        if proc is None:
            logs[n] = ""
            continue
        logs[n], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}:\n{logs[n]}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
