"""Build and load the hand-written CUDA kernels (csrc/recon.cu).

nvcc compiles the source into a shared library with a plain C interface,
loaded with ctypes — seconds per build, where a source that includes
PyTorch's headers takes minutes.  The build runs at first use, keyed by a
digest of the source and the flags, into `build/mpeg_tpu_torch/` at the
root of the checkout (as mpeg_tpu/native.py builds the C++ parser).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "recon.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mpeg_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None


def nvcc_path() -> str | None:
    """nvcc of the CUDA toolkit torch finds (CUDA_HOME, CUDA_PATH, nvcc
    on PATH, the toolkit's default install), or None."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        return None
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return nvcc if os.path.exists(nvcc) else None


def build(source: str = SOURCE) -> tuple[str, str]:
    """Compile `source` (recon.cu, or an earlier commit's copy of it to
    time against) if its digest has no library yet.

    Returns (library path, the compiler's log: the -Xptxas -v register
    and shared-memory lines)."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (CUDA tensors need them)")
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"librecon-{digest}.so")
    log = so + ".log"
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        out = subprocess.run([nvcc, *NVCC_FLAGS, source, "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        with open(log, "w") as f:
            f.write(out.stdout + out.stderr)
        os.replace(tmp, so)
    with open(log) as f:
        return so, f.read()


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def bind(so: str) -> ctypes.CDLL:
    """A built library with its entry points' argument types set."""
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mt_idct_batch.argtypes = [p, p, p, i64, p]
    lib.mt_idct_batch.restype = i32
    lib.mt_reconstruct_pictures.argtypes = [p] * 5 + [i32] + [p] * 6 + \
        [i32, i32, p]
    lib.mt_reconstruct_pictures.restype = i32
    lib.mt_reconstruct_plane.argtypes = [p] * 10 + [i32, i32, i32, p]
    lib.mt_reconstruct_plane.restype = i32
    lib.mt_error_string.argtypes = [i32]
    lib.mt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a nonzero cudaGetLastError code."""
    if code != 0:
        msg = load().mt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
