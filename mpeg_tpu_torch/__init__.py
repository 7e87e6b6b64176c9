"""mpeg_tpu_torch — the MPEG-1 video decoder in PyTorch, for NVIDIA Hopper.

A port of `mpeg_tpu`'s windowed and many-stream video decode that
imports nothing of `mpeg_tpu` or jax.  It keeps its own copy of the host
half under the names of its counterparts: the C++ parser and PS demuxer
(`csrc/host/`, bound by `native`), the Python plan parser (`video`,
`buffer`, `demux`, `tables`), `config`, `utils` and the window-blob
layout in `parallel.batch`.  The code that ran on the TPU is ported:

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

The decoders run on the card by default (`device="cuda"`, which raises
without one); `device="cpu"` runs the plain versions.

    from mpeg_tpu_torch.parallel import BatchVideoDecoder
    dec = BatchVideoDecoder(open("clip.m1v", "rb").read(), window=16)
    frames = dec.decode_all()     # flat uint8 [total_size] CUDA tensors
"""

from .device import probe, resolve_device

__all__ = ["probe", "resolve_device"]
