"""mpeg_tpu_torch — the MPEG-1 video / MP2 audio / MPEG-PS decoder in
PyTorch, for NVIDIA Hopper.

A port of `mpeg_tpu` that imports nothing of `mpeg_tpu` or jax: the
reference-shaped API (`MPEG`, `Video`, `Audio`, `Frame`, `Samples`), the
windowed throughput decoders (`parallel.BatchVideoDecoder`,
`parallel.BatchAudioDecoder`) and the many-stream video decode.  It keeps
its own copy of the host half under the names of its counterparts: the
C++ parsers and PS demuxer (`csrc/host/`, bound by `native`), the Python
parsers (`video`, `audio`, `buffer`, `demux`, `tables`), the PS plumbing
(`mpeg`, `pipeline`), `config`, `utils` and the window-blob layout in
`parallel.batch`.  The code that ran on the TPU is ported:

- `ops.video_recon`: plain PyTorch versions of the exact integer IDCT and
  the picture reconstructs (the CPU path and the reference the kernels
  are held against);
- `ops.cuda_kernels`: wrappers around the hand-written CUDA kernels in
  `csrc/recon.cu` (K1-K3) and `csrc/synth.cu` (K4, the MP2 synthesis),
  each built with nvcc into a library of its own on first use (see
  `ops._build`);
- `ops.color`: YCbCr -> RGBA;
- `ops.filterbank`: the plain version of K4, the MP2 synthesis
  filterbank in plain torch ops, bit-exact (no FMA; see its docstring);
- `parallel.batch`: the window-blob densify, the per-window decode module
  and `BatchVideoDecoder`;
- `parallel.multistream`: the lockstep many-stream decode module and
  `MultiStreamVideoDecoder`;
- `testing`: seeded adversarial inputs for holding the kernels against
  their plain versions.

The decoders run on the card by default (`device="cuda"`, which raises
without one); `device="cpu"` runs the plain versions.

    import mpeg_tpu_torch as mpeg
    m = mpeg.MPEG(open("video.mpg", "rb"))
    frame = m.decode_video()      # Frame: .flat on the card, .y/.cb/.cr numpy
    samples = m.decode_audio()    # Samples: .interleaved float32 numpy

    from mpeg_tpu_torch.parallel import BatchVideoDecoder
    dec = BatchVideoDecoder(open("clip.m1v", "rb").read(), window=16)
    frames = dec.decode_all()     # flat uint8 [total_size] CUDA tensors
"""

from .audio import SAMPLES_PER_FRAME, Audio, AudioFormat, Samples
from .buffer import BUFFER_SIZE, Buffer
from .config import Config
from .demux import (
    PACKET_AUDIO_1, PACKET_AUDIO_2, PACKET_AUDIO_3, PACKET_AUDIO_4,
    PACKET_INVALID_TS, PACKET_PRIVATE, PACKET_VIDEO_1, Demux,
    InvalidHeaderError, Packet,
)
from .device import probe, resolve_device
from .mpeg import MPEG, InvalidMpegError
from .video import Frame, Video

__all__ = ["MPEG", "InvalidMpegError", "Config", "Video", "Frame",
           "Buffer", "BUFFER_SIZE", "Demux", "Packet", "InvalidHeaderError",
           "PACKET_INVALID_TS", "PACKET_PRIVATE", "PACKET_VIDEO_1",
           "PACKET_AUDIO_1", "PACKET_AUDIO_2", "PACKET_AUDIO_3",
           "PACKET_AUDIO_4", "Audio", "AudioFormat", "Samples",
           "SAMPLES_PER_FRAME", "probe", "resolve_device"]
