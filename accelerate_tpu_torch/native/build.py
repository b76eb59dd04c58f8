"""Build the CUDA sources under ``native/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the repository root (git-ignored). Nothing includes
PyTorch's headers, so a build takes seconds, not minutes. The libraries are
named by a hash of their source, so an edited source is rebuilt and a stale
one is never loaded. All sources compile in parallel (one ``nvcc`` each,
started together) the first time any kernel is needed; a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc output of the build that produced the loaded library
# (empty when the library was already built). `chip_smoke.py` prints it.
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels under "
        f"{CSRC_DIR} cannot be built"
    )


def library_path(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return build_dir / f"{src.stem}-{digest}.so"


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all(build_dir: Path = BUILD_DIR, nvcc: str | None = None) -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.

    Returns ``{name: library path}``. Each build writes to a temporary name
    and renames into place, so concurrent builders never load a half-written
    library."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    build_dir.mkdir(parents=True, exist_ok=True)
    out = {src.stem: library_path(src, build_dir) for src in sources}
    todo = [src for src in sources if not out[src.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc or find_nvcc()
    procs = []
    for src in todo:
        tmp = out[src.stem].with_suffix(f".tmp{os.getpid()}.so")
        procs.append((src, tmp, subprocess.Popen(
            nvcc_command(nvcc, src, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[src.stem] = log
        if proc.returncode != 0:
            failures.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[src.stem])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
        return lib
