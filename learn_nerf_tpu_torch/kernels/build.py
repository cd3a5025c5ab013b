"""Build ``csrc/`` into one shared library with ``nvcc`` and bind it with
``ctypes``.

The library is built at first use, on the machine with the card, into
``learn_nerf_tpu_torch/_build/<digest>/`` (git-ignored), where the digest
covers the sources and the compiler flags: a changed source builds anew,
and an unchanged one loads the library already built.  The sources have a
plain C interface and include no PyTorch header, so a build takes seconds.
Kernels are compiled for ``sm_90a`` (Hopper) only, without fast math.
"""

import contextlib
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to build.log
)


@dataclass
class LaunchCounter:
    """How often a wrapper launched its kernel, and how often it ran its
    plain PyTorch version instead (CPU tensors only)."""

    launches: int = 0
    plain_calls: int = 0

    def __post_init__(self):
        COUNTERS.append(self)

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


# Every LaunchCounter made, in order: a captured train step records which
# ones its capture moved, and moves them again at each replay
# (step_graph.StepGraphs).
COUNTERS = []


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
    """Compile the sources unless this digest is built; return the library.

    One ``nvcc -c`` per ``.cu`` source, all started together, then one
    link: the build takes as long as the slowest source, not their sum.
    """
    out_dir = library_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objects = [out_dir / f"{p.stem}.{tag}.o" for p in sources]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)
    ]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs, failed = [], []
    for cmd, proc in zip(compiles, procs):
        output = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} (nvcc exit {proc.returncode}):\n{output[-4000:]}")
    if not failed:
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (nvcc exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    (out_dir / "build.log").write_text("\n".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def bind_table_gather(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/table_gather.cu``'s entry points."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nerf_table_gather.argtypes = [ptr, i64, i32, ptr, i64, ptr, i32, ptr]
    lib.nerf_table_gather.restype = i32
    return lib


def bind_selection(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of ``csrc/selection.cu``'s entry points."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.nerf_select_strided.argtypes = (
        [ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32] + [f32] * 7 + [i32] + [f32] * 7 + [ptr] * 7
    )
    lib.nerf_select_strided.restype = i32
    lib.nerf_pool_pack.argtypes = [ptr, i64, ptr, ptr, i64, i32, i64] + [ptr] * 8
    lib.nerf_pool_pack.restype = i32
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nerf_fused_mlp.argtypes = [ptr] * 5 + [i64] + [i32] * 4 + [ptr]
    lib.nerf_fused_mlp.restype = i32
    lib.nerf_fused_render.argtypes = [ptr] * 6 + [i64, i32] + [i32] * 4 + [ptr]
    lib.nerf_fused_render.restype = i32
    bind_table_gather(lib)
    bind_selection(lib)
    lib.nerf_hashgrid_corners.argtypes = (
        [ptr, i64, ptr, ptr, ptr, i32] + [ctypes.c_float] * 6 + [i32, ptr, ptr, ptr]
    )
    lib.nerf_hashgrid_corners.restype = i32
    lib.nerf_hashgrid_encode.argtypes = [ptr, i64, ptr, ptr, ptr]
    lib.nerf_hashgrid_encode.restype = i32
    lib.nerf_hashgrid_backward.argtypes = [ptr, ptr, i64, ptr, ptr, ptr]
    lib.nerf_hashgrid_backward.restype = i32
    lib.nerf_hashgrid_dx.argtypes = [ptr, ptr, i64, ptr, ptr, ptr]
    lib.nerf_hashgrid_dx.restype = i32
    lib.nerf_hashgrid_dx_backward.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr]
    lib.nerf_hashgrid_dx_backward.restype = i32
    lib.nerf_composite_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr] * 5
    lib.nerf_composite_forward.restype = i32
    lib.nerf_composite_backward.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 8
    lib.nerf_composite_backward.restype = i32
    lib.nerf_composite_pooled_forward.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 4
    lib.nerf_composite_pooled_forward.restype = i32
    lib.nerf_composite_pooled_backward.argtypes = [ptr] * 10 + [i32] * 5 + [ptr] * 7
    lib.nerf_composite_pooled_backward.restype = i32
    lib.nerf_baked_lookup.argtypes = [ptr, i32, i32, i32, ptr, i64, i32] + [ctypes.c_float] * 6 + [ptr, ptr]
    lib.nerf_baked_lookup.restype = i32
    lib.nerf_ngp_mlp.argtypes = [ptr, ptr, i64, i32] + [ptr] * 10 + [ptr] * 3
    lib.nerf_ngp_mlp.restype = i32
    lib.nerf_hashgrid_encode_args_size.argtypes = []
    lib.nerf_hashgrid_encode_args_size.restype = i32
    lib.nerf_error_string.argtypes = [i32]
    lib.nerf_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Once loaded, a
    call takes no lock."""
    global _library
    lib = _library
    if lib is not None:
        return lib
    with _lock:
        if _library is None:
            _library = _bind(ctypes.CDLL(str(build())))
        return _library


_hopper_devices = set()


def require_hopper(device: torch.device) -> None:
    """Raise unless ``device`` is sm_90 (queried once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index in _hopper_devices:
        return
    major, minor = torch.cuda.get_device_capability(index)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {device} is "
            f"sm_{major}{minor}"
        )
    _hopper_devices.add(index)


def launch_context(device: torch.device):
    """A context that makes ``device`` current for a launch: none when it
    already is, which is the usual case."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw ``cudaStream_t``
    (``torch.cuda.current_stream()`` builds a Stream object: several
    microseconds a call, as long as a small kernel)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.nerf_error_string(err).decode()} ({err})"
        )
