"""Build and load the hand-written CUDA kernels (csrc/recon.cu, csrc/synth.cu,
csrc/densify.cu).

nvcc compiles each source into a shared library of its own with a plain C
interface, loaded with ctypes — seconds per build, where a source that
includes PyTorch's headers takes minutes.  A build runs at first use, keyed
by a digest of the source and its flags, into `build/mpeg_tpu_torch/` at the
root of the checkout (as mpeg_tpu/native.py builds the C++ parser).

`LIBRARIES` names each library's source, flags and binder: K4
(synth.cu) is bit-exact float32 only without FMA contraction and with the
IEEE quotient, so it adds `-fmad=false`, `-prec-div=true` and
`-ftz=false` (and never `--use_fast_math`); K5 (densify.cu) is integer work
with the default flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mpeg_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict = {}


def nvcc_path() -> str | None:
    """nvcc of the CUDA toolkit torch finds (CUDA_HOME, CUDA_PATH, nvcc
    on PATH, the toolkit's default install), or None."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        return None
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return nvcc if os.path.exists(nvcc) else None


def nvcc_flags(name: str) -> list:
    """The flags library `name` of `LIBRARIES` is built with."""
    return LIBRARIES[name][1]


def build(source: str, flags: list) -> tuple[str, str]:
    """Compile `source` (one of `LIBRARIES`' sources, or an earlier
    commit's copy of recon.cu to time against) with `flags` if its digest
    has no library yet.

    Returns (library path, the compiler's log: the -Xptxas -v register
    and shared-memory lines)."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (CUDA tensors need them)")
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    log = so + ".log"
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        out = subprocess.run([nvcc, *flags, source, "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed ({out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        with open(log, "w") as f:
            f.write(out.stdout + out.stderr)
        os.replace(tmp, so)
    with open(log) as f:
        return so, f.read()


def build_library(name: str) -> tuple[str, str]:
    """`build` of library `name` of `LIBRARIES` with its flags."""
    source, flags, _ = LIBRARIES[name]
    return build(source, flags)


def load(name: str = "recon") -> ctypes.CDLL:
    """Library `name` of `LIBRARIES`, built on first use."""
    if name not in _libs:
        _libs[name] = LIBRARIES[name][2](build_library(name)[0])
    return _libs[name]


def _bind_error_string(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mt_error_string.argtypes = [ctypes.c_int]
    lib.mt_error_string.restype = ctypes.c_char_p
    return lib


def bind(so: str) -> ctypes.CDLL:
    """A built recon.cu library with its entry points' argument types set."""
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mt_idct_batch.argtypes = [p, p, p, i64, p]
    lib.mt_idct_batch.restype = i32
    lib.mt_reconstruct_pictures.argtypes = [p] * 5 + [i32] + [p] * 6 + \
        [i32, i32, p]
    lib.mt_reconstruct_pictures.restype = i32
    lib.mt_reconstruct_plane.argtypes = [p] * 10 + [i32, i32, i32, p]
    lib.mt_reconstruct_plane.restype = i32
    return _bind_error_string(lib)


def bind_synth(so: str) -> ctypes.CDLL:
    """A built synth.cu library (K4) with its entry point's argument types
    set."""
    lib = ctypes.CDLL(so)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mt_synthesize.argtypes = [p, p, p, i32, p, i32, i32, i32, p, p, p]
    lib.mt_synthesize.restype = i32
    return _bind_error_string(lib)


class DensifyArgs(ctypes.Structure):
    """csrc/densify.cu `MtDensifyArgs`, field for field (`bind_densify`
    checks the size against the library's)."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("meta", "main")] + [
        ("meta_stride", ctypes.c_longlong), ("main_stride", ctypes.c_longlong),
    ] + [(name, ctypes.c_void_p) for name in (
        "premult", "nb_class_rep", "coeffs", "nblocks", "intra_blk",
        "src_sel", "mv_h", "mv_v", "is_ref", "is_noop", "scratch")] + [
        (name, ctypes.c_int) for name in (
            "streams", "window", "mb", "kt", "ke", "off_flags", "off_mv_h",
            "off_mv_v", "off_nbcls", "off_mbmisc", "off_esc_didx",
            "off_esc_val")]


def bind_densify(so: str) -> ctypes.CDLL:
    """A built densify.cu library (K5) with its entry points' argument
    types set."""
    lib = ctypes.CDLL(so)
    i32 = ctypes.c_int
    lib.mt_densify_args_bytes.argtypes = []
    lib.mt_densify_args_bytes.restype = i32
    if lib.mt_densify_args_bytes() != ctypes.sizeof(DensifyArgs):
        raise RuntimeError(
            f"densify.cu's MtDensifyArgs holds {lib.mt_densify_args_bytes()} "
            f"bytes, DensifyArgs {ctypes.sizeof(DensifyArgs)}")
    lib.mt_densify_scratch_words.argtypes = [i32] * 5
    lib.mt_densify_scratch_words.restype = ctypes.c_longlong
    lib.mt_densify_granule_mbs.argtypes = []
    lib.mt_densify_granule_mbs.restype = i32
    lib.mt_densify_unpack.argtypes = [ctypes.POINTER(DensifyArgs),
                                      ctypes.c_void_p, ctypes.POINTER(i32)]
    lib.mt_densify_unpack.restype = i32
    return _bind_error_string(lib)


# name -> (source, nvcc flags, binder)
LIBRARIES = {
    "recon": (os.path.join(_PKG, "csrc", "recon.cu"), NVCC_FLAGS, bind),
    "synth": (os.path.join(_PKG, "csrc", "synth.cu"),
              NVCC_FLAGS + ["-fmad=false", "-prec-div=true", "-ftz=false"],
              bind_synth),
    "densify": (os.path.join(_PKG, "csrc", "densify.cu"), NVCC_FLAGS,
                bind_densify),
}


def check(code: int, what: str, name: str = "recon") -> None:
    """Raise when a launch of library `name` returned a nonzero
    cudaGetLastError code."""
    if code != 0:
        msg = load(name).mt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
