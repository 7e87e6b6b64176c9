"""Windowed batch decode (video and MP2 audio) and many-stream lockstep
video decode on a torch device; `parallel.sharding` splits streams over
several devices and `parallel.multihost` over several processes."""

from .audio_batch import BatchAudioDecoder
from .batch import (BatchVideoDecoder, DenseWindowDecoder, PictureBlobRecon,
                    WindowDecoder, carry_from_numpy, make_dense_scan_decoder,
                    make_scan_decoder)
from .multistream import GlobalWindowDecoder, MultiStreamVideoDecoder

__all__ = ["BatchAudioDecoder", "BatchVideoDecoder", "DenseWindowDecoder",
           "GlobalWindowDecoder", "MultiStreamVideoDecoder",
           "PictureBlobRecon", "WindowDecoder", "carry_from_numpy",
           "make_dense_scan_decoder", "make_scan_decoder"]
