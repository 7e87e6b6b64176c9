"""The 60 s streaming soak through the port on the CPU (the counterpart of
tests/test_soak.py): a minute-long muxed PS (tools/ps_mux.py) demuxes the
same on the Python and native demuxers, seeks within the reference's
0.5 s, decodes through the native pipeline and the clip extractor, and
plays clock-driven with bounded buffers and A/V drift under 0.5 s."""

import pathlib
import sys

import numpy as np
import pytest

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch import native
from mpeg_tpu_torch.parallel import BatchVideoDecoder
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
from tools import ps_mux  # noqa: E402

VIDEO_SECONDS = 261 / 30.0
AUDIO_SECONDS = 355 * 1152 / 44100.0
TARGET_SECONDS = 60.0


@pytest.fixture(scope="module")
def long_mpg(tmp_path_factory, mpeg1video_path, mp2_path):
    path = tmp_path_factory.mktemp("soak") / "long.mpg"
    with open(path, "wb") as f:
        ps_mux.mux(mpeg1video_path.read_bytes(), mp2_path.read_bytes(),
                   VIDEO_SECONDS, AUDIO_SECONDS, TARGET_SECONDS, out=f)
    return path


def test_mux_parses_with_both_demuxers(long_mpg):
    buf = mpeg.Buffer(open(long_mpg, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    py = mpeg.Demux(buf)
    assert py.get_num_video_streams() == 1
    assert py.get_num_audio_streams() == 1
    nat = native.NativeDemuxer(long_mpg.read_bytes()) \
        if native.available() else None
    last_pts, packets = {}, 0
    while (p := py.decode()) is not None:
        if nat is not None:
            assert nat.decode() == (p.type, p.pts, bytes(p.data)), \
                f"packet {packets}"
        if p.pts != mpeg.PACKET_INVALID_TS:
            assert p.pts >= last_pts.get(p.type, -1.0), "PTS not monotone"
            last_pts[p.type] = p.pts
        packets += 1
    assert packets > 1000
    assert last_pts[mpeg.PACKET_VIDEO_1] >= TARGET_SECONDS - 1.0


def test_seek_on_long_stream(long_mpg):
    m = mpeg.MPEG(open(long_mpg, "rb"), device="cpu")
    assert m.has_headers()
    assert m.duration() >= TARGET_SECONDS - 1.0
    for target in (5.0, 23.7, 44.2, TARGET_SECONDS - 5.0):
        assert m.seek(target, True), f"seek({target}) failed"
        assert abs(m.time - target) < 0.5, \
            f"seek({target}) landed at {m.time:.3f}"
        assert m.decode_video() is not None


def test_long_stream_native_pipeline_and_clip(long_mpg):
    if not native.available():
        pytest.skip("native parser unavailable")
    data = long_mpg.read_bytes()
    dec = BatchVideoDecoder(data, window=64, device="cpu")
    assert isinstance(dec.native, native.NativePipeline)
    total = sum(len(w) for w in iter(dec.decode_window, []))
    assert total >= (TARGET_SECONDS - 1.0) * 30

    cdec, pts = BatchVideoDecoder.at_time(data, 45.0, window=32,
                                          device="cpu")
    frames = cdec.decode_all()
    assert 41.5 <= pts <= 46.5
    assert len(frames) >= (TARGET_SECONDS - 47.0) * 30
    assert np.asarray(frames[0])[:cdec.geom.frame_size].any()
    assert cdec._seek_scan_bytes < len(data) // 4, \
        (cdec._seek_scan_bytes, len(data))


def test_soak_bounded_memory_and_av_drift(long_mpg):
    m = mpeg.MPEG(open(long_mpg, "rb"), device="cpu")
    assert m.has_headers()
    frames, samples = [0], [0]
    m.set_video_callback(lambda _m, f: frames.__setitem__(0, frames[0] + 1))
    m.set_audio_callback(
        lambda _m, s: samples.__setitem__(0, samples[0] + len(s.left)))
    max_occupancy, max_drift, steps = 0, 0.0, 0
    while not m.done:
        m.decode(1.0 / 30.0)
        steps += 1
        if steps % 16 == 0:
            max_occupancy = max(max_occupancy, m.buffer_occupancy())
            max_drift = max(max_drift, abs(m.video_decoder.time -
                                           m.audio_decoder.time))
        assert steps < 20000, "decode loop did not terminate"
    assert frames[0] / 30.0 >= TARGET_SECONDS - 1.0
    assert samples[0] / 44100.0 >= TARGET_SECONDS - 1.0
    assert max_occupancy < 1_500_000, f"buffers grew to {max_occupancy}"
    assert max_drift < 0.5, f"A/V drift reached {max_drift:.3f}s"
