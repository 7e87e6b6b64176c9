"""Custom quantiser matrices through the port on the CPU (the counterpart
of tests/test_custom_matrix.py): `tests/testdata/test_custom_matrix.m1v`
is tools/gen_custom_matrix.py's splice of the 260-frame ES fixture,
committed so that the card's machine, which may lack the JAX package the
tool imports, decodes the same bytes.  Its golden, 0x82A9768F1F2B499B,
holds through the port's `Video` (both parsers), `BatchVideoDecoder`
(prefetch off and on) and `MultiStreamVideoDecoder` (plain versions).
Tolerance: exact."""

import hashlib
import io
import os
import sys

import numpy as np
import pytest

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch import native
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.utils import Fnv1a64
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_custom_matrix import (  # noqa: E402
    CUSTOM_INTRA, CUSTOM_NON_INTRA, splice_custom_matrices,
)

GOLDEN = 0x82A9768F1F2B499B
FRAMES = 260
SHA256 = "9a017baed6b44cf91530babe25aea02e6036c9fd89598c75b0fce7ecdfc5b1e2"


@pytest.fixture(scope="module")
def spliced(mpeg1video_path):
    path = mpeg1video_path.parent / "test_custom_matrix.m1v"
    return path.read_bytes()


def test_fixture_is_the_tools_splice(spliced, mpeg1video_path):
    assert hashlib.sha256(spliced).hexdigest() == SHA256
    assert spliced == splice_custom_matrices(mpeg1video_path.read_bytes())


def _hash(frames, fs) -> int:
    h = Fnv1a64()
    for f in frames:
        h.write(np.asarray(f)[:fs].tobytes())
    return h.sum64()


@pytest.mark.parametrize("parser", ["python", "native"])
def test_video_golden(spliced, parser):
    if parser == "native" and not native.available():
        pytest.skip("native parser unavailable")
    buf = mpeg.Buffer(io.BytesIO(spliced))
    buf.set_load_callback(buf.load_reader_callback)
    v = mpeg.Video(buf, parser=parser, device="cpu")
    h, n = Fnv1a64(), 0
    while (f := v.decode()) is not None:
        h.write(f.y.tobytes())
        h.write(f.cb.tobytes())
        h.write(f.cr.tobytes())
        n += 1
    assert n == FRAMES
    if parser == "python":          # the C++ parser keeps its own copy
        assert tuple(v.intra_quant_matrix) == CUSTOM_INTRA
        assert tuple(v.non_intra_quant_matrix) == CUSTOM_NON_INTRA
    assert h.sum64() == GOLDEN, hex(h.sum64())


@pytest.mark.parametrize("prefetch", [False, True])
def test_batch_golden(spliced, prefetch):
    """The dequantised custom-matrix levels ride the blob's record lanes
    unchanged."""
    if not native.available():
        pytest.skip("native parser unavailable")
    dec = BatchVideoDecoder(spliced, window=16, prefetch=prefetch,
                            device="cpu")
    frames = dec.decode_all()
    assert len(frames) == FRAMES
    assert _hash(frames, dec.geom.frame_size) == GOLDEN


def test_multistream_golden(spliced, mpeg1video_path):
    """Beside a default-matrix stream, each stream on its own golden."""
    if not native.available():
        pytest.skip("native parser unavailable")
    es = mpeg1video_path.read_bytes()
    ms = MultiStreamVideoDecoder([spliced, es], window=8, device="cpu")
    got = ms.decode_all()
    fs = ms.geom.frame_size
    assert [len(g) for g in got] == [FRAMES, FRAMES]
    assert _hash(got[0], fs) == GOLDEN
    assert _hash(got[1], fs) == 0xEA6D7FCB1340BA3F
