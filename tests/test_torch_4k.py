"""3840x2160 through the port on the CPU (the counterpart of
tests/test_batch.py's 4K check): `tests/testdata/test4k.m1v` is the
8-frame ES tools/gen_4k.py writes (cv2), committed so that the card's
machine, which may lack cv2, decodes the same bytes.  A 4K picture has
32,400 macroblocks, about 4x the 1080p fixture's.  Tolerance: exact, frame
for frame against the JAX package's C++ host decoder."""

import hashlib
import importlib
import os
import sys

import numpy as np
import pytest

from mpeg_tpu import native as jax_native
from mpeg_tpu_torch import native
from mpeg_tpu_torch.parallel import BatchVideoDecoder
from torch_threads import one_torch_thread  # noqa: F401

SHA256 = "a7efdfdd61bcbdeab1608631028d8d9a70b3d9beea6c1ae0235cfeebe7fa2963"


@pytest.fixture(scope="module")
def es4k(mpeg1video_path):
    return (mpeg1video_path.parent / "test4k.m1v").read_bytes()


def test_fixture_is_the_tools_output(es4k, tmp_path, monkeypatch):
    assert hashlib.sha256(es4k).hexdigest() == SHA256
    pytest.importorskip("cv2")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    gen_4k = importlib.import_module("gen_4k")
    monkeypatch.setattr(gen_4k, "OUT", str(tmp_path / "test4k.m1v"))
    gen_4k.main()
    assert (tmp_path / "test4k.m1v").read_bytes() == es4k


def test_batch_decoder_4k_matches_host_decoder(es4k):
    if not (native.available() and jax_native.available()):
        pytest.skip("native parser unavailable")
    dec = BatchVideoDecoder(es4k, window=4, device="cpu")
    assert (dec.geom.width, dec.geom.height) == (3840, 2160)
    assert dec.geom.mb_size == 32_400
    fs = dec.geom.frame_size
    frames = [f[:fs].numpy() for f in dec.decode_all()]
    host = jax_native.NativeHostDecoder(es4k)
    n = 0
    while (ref := host.decode_next()) is not None:
        assert np.array_equal(frames[n], ref[:fs]), f"frame {n}"
        n += 1
    assert n == 8 == len(frames)
