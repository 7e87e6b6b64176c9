"""mpeg_tpu_torch — the decoder's device half in PyTorch, for NVIDIA Hopper.

A port of `mpeg_tpu`'s windowed and many-stream video decode.  The host
half (the C++ parser and PS demuxer, the Python parsers, the window-blob
layout) is imported from `mpeg_tpu` unchanged; only the code that ran on
the TPU is ported:

- `ops.video_recon`: plain PyTorch versions of the exact integer IDCT and
  the picture reconstructs (the CPU path and the reference the kernels
  are held against);
- `ops.cuda_kernels`: wrappers around the hand-written CUDA kernels in
  `csrc/recon.cu` (built with nvcc on first use, see `ops._build`);
- `ops.color`: YCbCr -> RGBA;
- `parallel.batch`: the window-blob densify, the per-window decode module
  and `BatchVideoDecoder`;
- `parallel.multistream`: the lockstep many-stream decode module and
  `MultiStreamVideoDecoder`;
- `testing`: seeded adversarial inputs for holding the kernels against
  their plain versions.

Every public entry takes an explicit `device`; nothing here imports jax.

    from mpeg_tpu_torch.parallel import BatchVideoDecoder
    dec = BatchVideoDecoder(open("clip.m1v", "rb").read(), window=16,
                            device="cuda")
    frames = dec.decode_all()     # flat uint8 [total_size] CUDA tensors
"""

from .device import probe, resolve_device

__all__ = ["probe", "resolve_device"]
