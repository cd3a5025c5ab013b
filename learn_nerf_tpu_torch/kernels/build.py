"""Build ``csrc/`` into one shared library with ``nvcc`` and bind it with
``ctypes``.

The library is built at first use, on the machine with the card, into
``learn_nerf_tpu_torch/_build/<digest>/`` (git-ignored), where the digest
covers the sources and the compiler flags: a changed source builds anew,
and an unchanged one loads the library already built.  The sources have a
plain C interface and include no PyTorch header, so a build takes seconds.
Kernels are compiled for ``sm_90a`` (Hopper) only, without fast math.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libnerf_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to build.log
)


@dataclass
class LaunchCounter:
    """How often a wrapper launched its kernel, and how often it ran its
    plain PyTorch version instead (CPU tensors only)."""

    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_dir() -> Path:
    """Where the library for the current sources is (or will be) built."""
    return BUILD_DIR / source_digest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the sources unless this digest is built; return the library."""
    out_dir = library_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with {proc.returncode}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nerf_fused_mlp.argtypes = [ptr] * 5 + [i64] + [i32] * 6 + [ptr]
    lib.nerf_fused_mlp.restype = i32
    lib.nerf_fused_render.argtypes = [ptr] * 6 + [i64, i32] + [i32] * 6 + [ptr]
    lib.nerf_fused_render.restype = i32
    lib.nerf_error_string.argtypes = [i32]
    lib.nerf_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            _library = _bind(ctypes.CDLL(str(build())))
        return _library


def require_hopper(device: torch.device) -> None:
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {device} is "
            f"sm_{major}{minor}"
        )


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.nerf_error_string(err).decode()} ({err})"
        )
