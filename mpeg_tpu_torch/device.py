"""Device selection and the environment probe."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """The torch.device for a `device` argument ("cuda", the entry points'
    default, or "cpu").

    Nothing falls back to another device: None is refused, and "cuda"
    raises when no CUDA device is present instead of running on the
    CPU."""
    if device is None:
        raise TypeError("device is required (\"cuda\" or \"cpu\")")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r}: CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} "
                         "(expected \"cuda\" or \"cpu\")")
    return dev


def explicit_device(device) -> torch.device:
    """`resolve_device` with a CUDA index always given: "cuda" becomes
    "cuda:i" for the current device i, so that two devices compare equal
    exactly when they are one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _first_line(cmd) -> str | None:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if out.returncode == 0 and lines else None


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    return _first_line(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])


def probe() -> dict:
    """One dict describing the torch build, the card and the compiler."""
    from .ops._build import nvcc_path

    cuda = torch.cuda.is_available()
    nvcc = nvcc_path()
    nvcc_version = None
    if nvcc is not None:
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=30).stdout
            rel = [ln for ln in out.splitlines() if "release" in ln]
            nvcc_version = rel[0].strip() if rel else None
        except (OSError, subprocess.TimeoutExpired):
            pass
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "sm": list(torch.cuda.get_device_capability(0)) if cuda else None,
        "name": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": gpu_name_and_power_limit() if cuda else None,
        "nvcc": nvcc_version,
    }
