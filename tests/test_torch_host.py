"""The port's own host half against the JAX package's, on the CPU: the
C++ parser sources byte-identical to `native/`'s, the copy's window
blobs (whole buffer and streamed in uneven chunks), the Python plan
parser and `pack_plans_blob`, and `FrameGeometry`, on the three fixtures
at window 16.  Tolerance: equal bytes."""

import dataclasses
import io
import pathlib

import numpy as np
import pytest

import mpeg_tpu as jmpeg
from mpeg_tpu.ops.video_recon import FrameGeometry as JaxGeometry
from mpeg_tpu.parallel import BatchVideoDecoder as JaxBatchVideoDecoder
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu_torch import native
from mpeg_tpu_torch.buffer import Buffer
from mpeg_tpu_torch.demux import PACKET_VIDEO_1, Demux
from mpeg_tpu_torch.ops.video_recon import FrameGeometry
from mpeg_tpu_torch.parallel import BatchVideoDecoder
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.video import Video
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).parent.parent
TESTDATA = REPO / "tests" / "testdata"
FIXTURES = ["test.mpeg1video", "test.mpg", "test1080.m1v"]
WINDOW = 16
# Pictures the Python plan parsers take of each fixture (a 1080p
# picture costs 0.2-0.8 s in Python, so that fixture gives three).
PY_PICTURES = {"test.mpeg1video": WINDOW, "test.mpg": WINDOW,
               "test1080.m1v": 3}

needs_gxx = pytest.mark.skipif(not native.available(),
                               reason="needs g++ for the host parser")


@pytest.mark.parametrize("name", ["parser.cpp", "vlc_tables.h"])
def test_parser_sources_equal_native(name):
    """The port's parser sources are copies of the JAX package's: a fix
    goes into both, and this holds them equal, also where the fixtures'
    blobs do not reach."""
    got = (REPO / "mpeg_tpu_torch" / "csrc" / "host" / name).read_bytes()
    assert got == (REPO / "native" / name).read_bytes()


def _windows(dec, chunks=None):
    """Every window blob the decoder's host half packs, as (types, caps,
    fill, {field: bytes}); with `chunks`, fed in those pieces."""
    out = []

    def drain():
        while True:
            blob, _plans, types, caps, _t, fill = dec._parse_stage()
            if not types:
                return
            views = tb.blob_views(blob, dec.geom, dec.window, *caps)
            out.append((list(types), caps, fill,
                        {k: v.tobytes() for k, v in views.items()}))

    if chunks is None:
        drain()
    else:
        for c in chunks:
            dec.feed(c)
            if dec.native is not None and dec.native.has_header():
                drain()
        dec.signal_end()
        drain()
    return out


def _uneven(data: bytes) -> list:
    sizes, pos, out = (7919, 30011, 1, 65537, 4093), 0, []
    while pos < len(data):
        n = sizes[len(out) % len(sizes)]
        out.append(data[pos:pos + n])
        pos += n
    return out


@needs_gxx
@pytest.mark.parametrize("name", FIXTURES)
def test_native_window_blobs_match_jax(name):
    """The port's parser copy packs the JAX package's window blobs byte
    for byte, every field, window after window through the bucket growth,
    from the whole buffer and streamed in uneven chunks."""
    data = (TESTDATA / name).read_bytes()
    jdec = JaxBatchVideoDecoder(data, window=WINDOW)
    dec = BatchVideoDecoder(data, window=WINDOW, device="cpu")
    assert dataclasses.astuple(dec.geom) == dataclasses.astuple(jdec.geom)
    want, got = _windows(jdec), _windows(dec)
    assert len(got) == len(want) > 1
    assert got == want
    assert sum(len(t) for t, *_ in got) >= 32

    chunks = _uneven(data)
    want = _windows(JaxBatchVideoDecoder(b"", window=WINDOW, streaming=True,
                                         use_native=True), chunks)
    got = _windows(BatchVideoDecoder(b"", window=WINDOW, streaming=True,
                                     use_native=True, device="cpu"), chunks)
    assert len(got) == len(want) > 1
    assert got == want


def _es(data: bytes) -> bytes:
    """The video elementary stream of an MPEG-PS buffer (the port's
    demuxer); an elementary stream as it is."""
    if data[:4] != b"\x00\x00\x01\xBA":
        return data
    buf = Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    dmx, es = Demux(buf), bytearray()
    while (packet := dmx.decode()) is not None:
        if packet.type == PACKET_VIDEO_1:
            es += bytes(packet.data[:packet.length])
    return bytes(es)


def _plans(video_cls, buffer_cls, es: bytes, n: int):
    buf = buffer_cls(io.BytesIO(es))
    buf.set_load_callback(buf.load_reader_callback)
    video = video_cls(buf, backend="plan")
    plans = []
    while len(plans) < n and (item := video.parse_next_plan()) is not None:
        plans.append(item)
    return video.geom, plans


@needs_gxx
@pytest.mark.parametrize("name", FIXTURES)
def test_python_plans_pack_like_jax(name):
    """The port's Python plan parser gives the JAX package's plans, and
    the port's `pack_plans_blob` packs them into the same bytes."""
    es = _es((TESTDATA / name).read_bytes())
    n = PY_PICTURES[name]
    geom, got = _plans(Video, Buffer, es, n)
    jgeom, want = _plans(jmpeg.Video, jmpeg.Buffer, es, n)
    assert len(got) == len(want) == n
    for (p, t), (q, u) in zip(got, want):
        assert t == u
        for field in ("coeffs", "nblocks", "intra_blk", "src_sel", "mv_h",
                      "mv_v"):
            np.testing.assert_array_equal(getattr(p, field),
                                          getattr(q, field))
    nm, ne = tb.count_pool_records(got)
    assert (nm, ne) == jb.count_pool_records(want)
    km, ke = tb.pool_bucket(nm, tb._MIN_KM), tb.pool_bucket(ne, tb._MIN_KE)
    blob = tb.pack_plans_blob(got, geom, WINDOW, km, ke)
    np.testing.assert_array_equal(
        blob, jb.pack_plans_blob(want, jgeom, WINDOW, km, ke))
    assert tb.blob_split(geom, WINDOW, km, ke) == \
        jb.blob_split(jgeom, WINDOW, km, ke)


@pytest.mark.parametrize("size", [(160, 120), (320, 240), (1920, 1080),
                                  (80, 48), (272, 64)])
def test_frame_geometry_matches_jax(size):
    got, want = FrameGeometry.for_size(*size), JaxGeometry.for_size(*size)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for prop in ("mb_size", "luma_width", "luma_height", "chroma_width",
                 "chroma_height", "luma_size", "chroma_size", "frame_size",
                 "total_size"):
        assert getattr(got, prop) == getattr(want, prop), prop
