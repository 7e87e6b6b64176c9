"""Windowed batch decode (video and MP2 audio) and many-stream lockstep
video decode on a torch device."""

from .audio_batch import BatchAudioDecoder
from .batch import (BatchVideoDecoder, PictureBlobRecon, WindowDecoder,
                    carry_from_numpy)
from .multistream import GlobalWindowDecoder, MultiStreamVideoDecoder

__all__ = ["BatchAudioDecoder", "BatchVideoDecoder", "GlobalWindowDecoder",
           "MultiStreamVideoDecoder", "PictureBlobRecon", "WindowDecoder",
           "carry_from_numpy"]
