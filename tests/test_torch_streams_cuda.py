"""Custom quantiser matrices, corrupt streams and 4K through K5 and K1 on
the card: the custom-matrix ES (tests/testdata/test_custom_matrix.m1v)
on its golden 0x82A9768F1F2B499B through `Video` (both parsers),
`BatchVideoDecoder` (prefetch off and on) and `MultiStreamVideoDecoder`;
tests/test_torch_fuzz.py's bit-flipped and truncated ES, MP2 and PS
through `Audio`, `MPEG` and `BatchVideoDecoder` on the card, none
raising; and the 8-frame 3840x2160 ES (tests/testdata/test4k.m1v, 32,400
macroblocks a picture) through `BatchVideoDecoder` at window 4 and
`MultiStreamVideoDecoder`, equal to the C++ host decoder frame for frame.
Marked `cuda`: each test skips inside its body without a card
(`python -m pytest --noconftest tests/test_torch_streams_cuda.py -q -m
cuda`).  This module imports only the port.  Tolerance: exact."""

import io
import pathlib

import numpy as np
import pytest
import torch

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch.native import NativeHostDecoder, NativeVideoParser
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.utils import Fnv1a64
from test_torch_fuzz import (
    bitflip, drive_audio, drive_batch, drive_ps, drive_video,
)

TESTDATA = pathlib.Path(__file__).parent / "testdata"
CUSTOM = TESTDATA / "test_custom_matrix.m1v"
ES = TESTDATA / "test.mpeg1video"
GOLDEN_CUSTOM = (260, 0x82A9768F1F2B499B)
GOLDEN_DEFAULT = (260, 0xEA6D7FCB1340BA3F)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


def _golden(frames, fs):
    h = Fnv1a64()
    for f in frames:
        h.write(f[:fs].cpu().numpy().tobytes())
    return len(frames), h.sum64()


@pytest.mark.parametrize("parser", ["python", "native"])
def test_custom_matrix_video(parser):
    _card()
    buf = mpeg.Buffer(io.BytesIO(CUSTOM.read_bytes()))
    buf.set_load_callback(buf.load_reader_callback)
    v = mpeg.Video(buf, parser=parser, device="cuda")
    cuda_kernels.reset_launches()
    frames = []
    while (f := v.decode()) is not None:
        frames.append(f.flat.clone())
    plans = NativeVideoParser(CUSTOM.read_bytes())
    pictures = 0
    while plans.parse_next_plan() is not None:
        pictures += 1
    assert cuda_kernels.reconstruct_picture.launches == pictures > 0
    assert _golden(frames, v.geom.frame_size) == GOLDEN_CUSTOM


@pytest.mark.parametrize("prefetch", [False, True])
def test_custom_matrix_batch(prefetch):
    _card()
    dec = BatchVideoDecoder(CUSTOM.read_bytes(), window=16,
                            prefetch=prefetch, device="cuda")
    frames = dec.decode_all()
    assert _golden(frames, dec.geom.frame_size) == GOLDEN_CUSTOM


def test_custom_matrix_multistream():
    _card()
    ms = MultiStreamVideoDecoder([CUSTOM.read_bytes(), ES.read_bytes()],
                                 window=8, prefetch=True, device="cuda")
    got = ms.decode_all()
    fs = ms.geom.frame_size
    assert _golden(got[0], fs) == GOLDEN_CUSTOM
    assert _golden(got[1], fs) == GOLDEN_DEFAULT


@pytest.mark.parametrize("i", range(0, 16, 3))
def test_bitflip_streams_never_raise_on_the_card(i):
    _card()
    es = bitflip(ES.read_bytes(), i)
    for parser in ("python", "native"):
        drive_video(es, parser)
        drive_audio(bitflip((TESTDATA / "test.mp2").read_bytes(), i),
                    parser, device="cuda")
        drive_ps(bitflip((TESTDATA / "test.mpg").read_bytes(), i), parser,
                 device="cuda")
    drive_batch(es, device="cuda")
    MultiStreamVideoDecoder([es, ES.read_bytes()], window=4,
                            device="cuda").decode_all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("frac", [0.003, 0.01, 0.5])
def test_truncated_streams_never_raise_on_the_card(frac):
    _card()
    cut = lambda name: (TESTDATA / name).read_bytes()[  # noqa: E731
        :int((TESTDATA / name).stat().st_size * frac)]
    for parser in ("python", "native"):
        drive_audio(cut("test.mp2"), parser, device="cuda")
        drive_ps(cut("test.mpg"), parser, device="cuda")
    drive_batch(cut("test.mpeg1video"), device="cuda")
    torch.cuda.synchronize()


def _host_frames(data, fs):
    ref, out = NativeHostDecoder(data), []
    while (f := ref.decode_next()) is not None:
        out.append(f[:fs])
    return out


def test_4k_batch_and_multistream():
    _card()
    data = (TESTDATA / "test4k.m1v").read_bytes()
    dec = BatchVideoDecoder(data, window=4, device="cuda")
    assert dec.geom.mb_size == 32_400
    fs = dec.geom.frame_size
    want = _host_frames(data, fs)
    assert len(want) == 8
    frames = dec.decode_all()
    assert len(frames) == 8
    for i, (a, b) in enumerate(zip(frames, want)):
        assert np.array_equal(a[:fs].cpu().numpy(), b), f"batch frame {i}"
    ms = MultiStreamVideoDecoder([data, data[:len(data) // 2]], window=2,
                                 device="cuda")
    got = ms.decode_all()
    assert len(got[0]) == 8 and 0 < len(got[1]) < 8
    for i, (a, b) in enumerate(zip(got[0], want)):
        assert np.array_equal(a[:fs].cpu().numpy(), b), \
            f"multistream frame {i}"
