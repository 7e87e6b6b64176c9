"""Windowed batch decode and many-stream lockstep decode on a torch
device."""

from .batch import BatchVideoDecoder, WindowDecoder, carry_from_numpy
from .multistream import GlobalWindowDecoder, MultiStreamVideoDecoder

__all__ = ["BatchVideoDecoder", "GlobalWindowDecoder",
           "MultiStreamVideoDecoder", "WindowDecoder", "carry_from_numpy"]
