"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` exports plain ``extern "C"`` functions; it is compiled
into ``_build/lib<name>-<hash>.so`` (a directory that git ignores) and loaded
with ``ctypes``. The hash covers the source and the flags, so a checkout never
uses a library built from other code. The library is written under a
temporary name and moved into place with ``os.replace``, so processes that
build at the same time never load half a file. No PyTorch headers, no
``torch.utils.cpp_extension``, no ninja: one ``nvcc`` call per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    """A loaded kernel library: where it is, the seconds this process spent
    building it (0 if it was already built), and nvcc's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


_loaded: dict[str, Built] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default place, ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the CUDA kernels of tpu2048_torch are built "
        "with nvcc at first use on a machine with the CUDA toolkit")


def _compile(src: Path, out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{out.stem}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return log


def load(name: str, signatures: dict, src: Path | None = None) -> Built:
    """Build (once per source hash) and load ``csrc/<name>.cu``, or the
    source ``src`` under the name ``name`` (an earlier commit's kernel,
    built beside the current one to be timed against it).

    ``signatures`` maps each exported function to ``(restype, argtypes)``;
    they are set on the loaded library, since ctypes would otherwise pass
    every argument as a 32-bit int and cut pointers."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = Path(src) if src is not None else CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if path.exists():
            log = path.with_suffix(".log").read_text()
            seconds = 0.0
        else:
            log = _compile(src, path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        built = Built(lib, path, seconds, log)
        _loaded[name] = built
        return built
