"""The port's reference-shaped API (`mpeg_tpu_torch.Video`, `Frame`,
`MPEG`) on the CPU against the goldens and the JAX package, byte for
byte (tolerance 0): each picture reconstructs through one blob transfer
and K1's plain version; the checks of tests/test_mpeg.py and
tests/test_state.py run on the port."""

import io
import os
import sys

import numpy as np
import pytest
import torch

import mpeg_tpu as jmpeg
import mpeg_tpu_torch as tmpeg
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.utils import Fnv1a64

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from ps_mux import mux  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

GOLDEN_VIDEO = (260, 0xEA6D7FCB1340BA3F)      # test.mpeg1video
GOLDEN_PS_VIDEO = (278, 0xD00818EDCAFDC702)   # test.mpg, as BatchVideoDecoder
# test.mpg's audio through MPEG.decode_audio, pinned from the JAX package's
# MPEG(backend="numpy") by test_ps_digests_match_jax; chip_smoke.py holds
# the port on the card to the same constant.
GOLDEN_PS_AUDIO = (355, 0xF1B76CDF8E6CDEA5)


def _port_video(data: bytes, parser: str = "native"):
    buf = tmpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    return tmpeg.Video(buf, parser=parser, device="cpu")


def _jax_video(data: bytes, parser: str = "python"):
    buf = jmpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    return jmpeg.Video(buf, backend="numpy", parser=parser)


def _flats(video, limit: int = None) -> list:
    out = []
    while (limit is None or len(out) < limit) and \
            (f := video.decode()) is not None:
        flat = f.flat
        out.append(flat.numpy().copy() if isinstance(flat, torch.Tensor)
                   else np.asarray(flat).copy())
    return out


def _digest(flats, frame_size: int) -> int:
    h = Fnv1a64()
    for f in flats:
        h.write(f[:frame_size].tobytes())
    return h.sum64()


@pytest.fixture(scope="module")
def es(mpeg1video_path) -> bytes:
    return open(mpeg1video_path, "rb").read()


@pytest.fixture(scope="module")
def jax_frames(es) -> list:
    return _flats(_jax_video(es))


@pytest.mark.parametrize("parser", ["native", "python"])
def test_video_golden_and_equal_to_jax(es, jax_frames, parser):
    """Every frame equal to the JAX Video(backend="numpy")'s, the whole
    stream on the golden, K1 (its plain version here) once a picture."""
    video = _port_video(es, parser)
    assert video.get_width() == 160 and video.get_height() == 120
    assert video.framerate() == 30.0
    cuda_kernels.reset_launches()
    got = _flats(video)
    assert (len(got), _digest(got, video.geom.frame_size)) == GOLDEN_VIDEO
    assert cuda_kernels.reconstruct_picture.launches == 0   # CPU: plain
    for i, (a, b) in enumerate(zip(got, jax_frames)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    assert video.decode() is None and video.has_ended()


def test_set_no_delay_matches_jax(es):
    cut = es[:90000]
    port, ref = _port_video(cut), _jax_video(cut)
    port.set_no_delay(True)
    ref.set_no_delay(True)
    got, want = _flats(port), _flats(ref)
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_frame_views_and_rgba_match_jax(es):
    port, ref = _port_video(es), _jax_video(es)
    for _ in range(4):
        f, r = port.decode(), ref.decode()
        assert isinstance(f.flat, torch.Tensor)
        assert (f.width, f.height, f.time) == (r.width, r.height, r.time)
        for name in ("y", "cb", "cr"):
            a, b = getattr(f, name), getattr(r, name)
            assert isinstance(a, np.ndarray) and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(f.ycbcr(), r.ycbcr()):
            np.testing.assert_array_equal(a, b)
        rgba = f.rgba()
        assert rgba.shape == (120, 160, 4) and rgba.dtype == np.uint8
        np.testing.assert_array_equal(rgba, r.rgba())
        np.testing.assert_array_equal(f.pixels(), r.pixels())


@pytest.mark.parametrize("parser", ["python", "native"])
def test_jax_video_state_resumes_in_port(es, parser):
    """A JAX `Video.get_state()` (three frames, clocks, stream position)
    set into the port's Video continues exactly as the JAX decoder does
    (tests/test_state.py's check, across the two packages)."""
    ref = _jax_video(es, parser)
    _flats(ref, 10)
    state = ref.get_state()
    want = _flats(ref, 5)
    port = _port_video(es, parser)
    _flats(port, 2)
    port.set_state(state)
    got = _flats(port, 5)
    assert port.time == ref.time
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    own = port.get_state()
    again = _flats(port, 3)
    port.set_state(own)
    for a, b in zip(_flats(port, 3), again):
        np.testing.assert_array_equal(a, b)


def test_backends_and_devices(es):
    buf = tmpeg.Buffer(io.BytesIO(es))
    for backend in ("jax", "numpy"):
        with pytest.raises(ValueError, match='device="cpu"'):
            tmpeg.Video(buf, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tmpeg.Video(buf, backend="xla", device="cpu")
    buf = tmpeg.Buffer(io.BytesIO(es))
    buf.set_load_callback(buf.load_reader_callback)
    plan = tmpeg.Video(buf, backend="plan")
    first, ptype = plan.parse_next_plan()
    assert ptype == 1 and first.coeffs.shape == (80, 6, 64)
    if not torch.cuda.is_available():
        for make in (lambda: tmpeg.Video(tmpeg.Buffer(io.BytesIO(es))),
                     lambda: tmpeg.MPEG(open(os.path.join(
                         os.path.dirname(__file__), "testdata", "test.mpg"),
                         "rb"))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


# -- the native one-picture path: no dense plan -------------------------------

@pytest.fixture
def no_dense_plan(monkeypatch):
    """The dense plan and its numpy record pass raise: what decodes under
    this fixture came from the C++ parser's blob emitter alone."""
    from mpeg_tpu_torch import video as video_mod
    from mpeg_tpu_torch.parallel import batch

    def boom(*_a, **_k):
        raise AssertionError("dense plan on the native interactive path")

    monkeypatch.setattr(video_mod, "_PicturePlan", boom)
    monkeypatch.setattr(batch, "plan_pool_records", boom)


def test_native_video_emits_without_a_dense_plan(es, jax_frames,
                                                 no_dense_plan):
    """Video(parser="native") over the ES: each picture's blob comes from
    the C++ emitter (`native_picture_blobs` one a picture), and its frames
    equal the JAX Video's."""
    from mpeg_tpu_torch.utils import profiling
    video = _port_video(es, "native")
    with profiling.collect() as col:
        got = _flats(video, 30)
    assert len(got) == 30
    for i, (a, b) in enumerate(zip(got, jax_frames)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    # One picture ahead of the display (the reference frame's delay).
    assert col.counts["native_picture_blobs"] == 31


def test_native_1080p_grows_its_pools_and_equals_python(mpeg1video_path):
    """The first pictures of the 1080p fixture grow the sticky pool
    buckets from zero past their floor on the native path, and its frames
    are bit-exact with the Python parser's dense-plan path."""
    from mpeg_tpu_torch.parallel import batch
    from mpeg_tpu_torch.utils import profiling
    data = (mpeg1video_path.parent / "test1080.m1v").read_bytes()
    frames, counts, pools = {}, {}, {}
    for parser in ("native", "python"):
        video = _port_video(data, parser)
        with profiling.collect() as col:
            frames[parser] = _flats(video, 2)
        counts[parser] = col.counts
        pools[parser] = (video._blob_km, video._blob_ke)
    assert counts["native"]["pool_growths"] > 0
    assert counts["native"]["native_picture_blobs"] == 3
    assert "native_picture_blobs" not in counts["python"]
    assert pools["native"][0] > batch._MIN_KM
    assert len(frames["native"]) == len(frames["python"]) == 2
    for a, b in zip(frames["native"], frames["python"]):
        np.testing.assert_array_equal(a, b)


def test_prepared_picture_dropped_by_rewind_and_set_state(es):
    """A picture prepared in the native parser and never emitted (its
    emit is `_reconstruct`'s) is dropped by a rewind or a `set_state`:
    what decodes next is exact (the JAX Video rewound at the same frame;
    a rewind keeps the reference frames, as the reference's does)."""
    ref = _jax_video(es)
    _flats(ref, 5)
    ref.rewind()
    video = _port_video(es, "native")
    _flats(video, 5)
    assert video._native_next_plan() is not None
    video.rewind()
    got, want = _flats(video, 8), _flats(ref, 8)
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")

    ref = _port_video(es, "native")
    _flats(ref, 10)
    state = ref.get_state()
    want = _flats(ref, 5)
    video = _port_video(es, "native")
    _flats(video, 3)
    assert video._native_next_plan() is not None
    video.set_state(state)
    got = _flats(video, 5)
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


# -- MPEG (tests/test_mpeg.py on the port) -----------------------------------

def new_mpeg(path, **kw):
    return tmpeg.MPEG(open(path, "rb"), device="cpu", **kw)


def test_mpeg(mpg_path):
    m = new_mpeg(mpg_path)
    assert m.probe(5000 * 1024)
    assert m.has_headers()
    assert m.num_audio_streams() == 1
    assert m.num_video_streams() == 1
    assert (m.width(), m.height(), m.framerate()) == (160, 120, 30.0)

    m.set_audio_stream(0)
    m.set_audio_enabled(True)
    assert m.audio_enabled
    m.set_video_enabled(True)
    assert m.video_enabled
    assert m.samplerate() == 44100
    assert m.channels() == 1

    m.set_audio_lead_time(1.0)
    assert m.audio_lead_time == 1.0
    assert int(m.duration()) == 9

    m.rewind()
    m.set_loop(False)
    assert not m.loop

    m.set_audio_enabled(False)
    m.set_video_enabled(True)
    frame = m.decode_video()
    assert frame is not None
    assert frame.width == m.width()
    assert frame.y.size == 20480
    assert frame.cb.size == frame.y.size // 4

    m.set_audio_enabled(True)
    m.set_video_enabled(False)
    samples = m.decode_audio()
    assert samples is not None
    assert len(samples.bytes()) == len(samples.interleaved) * 4
    m.set_audio_format(tmpeg.AudioFormat.S16)
    assert m.audio_format() == tmpeg.AudioFormat.S16
    samples = m.decode_audio()
    assert len(samples.bytes()) == len(samples.interleaved) * 2

    m.set_audio_enabled(True)
    m.set_video_enabled(True)
    assert m.seek(1.0, False)
    frame = m.seek_frame(1.0, True)
    assert frame is not None and frame.time >= 1.0

    # Seeking past the end clamps to the duration, returns the last frame.
    frame = m.seek_frame(100.0, True)
    assert frame is not None
    assert frame.time >= m.duration() - 1.0

    m.set_audio_callback(lambda mp, s: None)
    m.set_video_callback(lambda mp, f: None)
    m.decode(1.0)


def test_invalid_source():
    with pytest.raises(tmpeg.InvalidMpegError):
        tmpeg.MPEG(io.BytesIO(b"\x00" * 64), device="cpu")


def test_seek_audio_time(mpg_path):
    """Exact seek off a frame boundary keeps audio time in sync
    (mpeg_test.go:402-438): the pipeline audio's PTS anchor."""
    tolerance = 0.5
    times = []
    for ms in (1000, 2000, 3000, 3001, 4000, 5000):
        m = new_mpeg(mpg_path)
        m.set_audio_callback(lambda mp, s: None)
        m.set_video_callback(lambda mp, f: None)
        assert m.seek(ms / 1000.0, True), f"seek to {ms}ms failed"
        stream_time = m.get_time()
        audio_time = m.audio().get_time()
        assert abs(audio_time - stream_time) <= tolerance, \
            f"seek {ms}ms: audio {audio_time} vs stream {stream_time}"
        times.append(audio_time)
    # A 1ms change must not jump the audio time.
    assert abs(times[3] - times[2]) <= tolerance


@pytest.mark.parametrize("exact", [False, True])
def test_seek_video_callback_once(mpg_path, exact):
    m = new_mpeg(mpg_path)
    count = [0]
    m.set_video_callback(lambda mp, f: count.__setitem__(0, count[0] + 1))
    m.set_audio_callback(lambda mp, s: None)
    assert m.seek(3.0, exact)
    assert count[0] == 1


@pytest.fixture(scope="module")
def short_ps(es, mp2_path) -> bytes:
    """40 pictures of test.mpeg1video and the MP2 fixture in one PS."""
    starts, pos = [], es.find(b"\x00\x00\x01\x00")
    while pos >= 0 and len(starts) <= 40:
        starts.append(pos)
        pos = es.find(b"\x00\x00\x01\x00", pos + 1)
    out = io.BytesIO()
    seconds = 40 / 30.0
    mux(es[:starts[40]], open(mp2_path, "rb").read(), video_seconds=seconds,
        audio_seconds=355 * 1152 / 44100.0, target_seconds=seconds, out=out)
    return out.getvalue()


def test_loop_and_done(short_ps):
    m = tmpeg.MPEG(short_ps, device="cpu")
    m.set_video_enabled(True)
    m.set_audio_enabled(False)
    # Without looping, decoding past the end sets has_ended.
    n = 0
    while m.decode_video() is not None:
        n += 1
        assert n < 1000
    assert n > 30
    assert m.has_ended() and m.done

    # With looping, the decoder rewinds instead of ending.
    m2 = tmpeg.MPEG(short_ps, device="cpu")
    m2.set_video_enabled(True)
    m2.set_audio_enabled(False)
    m2.set_loop(True)
    seen = 0
    while seen < n + 5:
        if m2.decode_video() is not None:
            seen += 1
        assert not m2.has_ended()
    assert seen > n   # wrapped around


def _player_output(m) -> tuple:
    """(frames' Y|Cb|Cr bytes, PCM arrays) of every callback of a
    decode(1/30) loop to `done`."""
    frames, pcm = [], []
    m.set_video_callback(lambda _m, f: frames.append(
        f.y.tobytes() + f.cb.tobytes() + f.cr.tobytes()))
    m.set_audio_callback(
        lambda _m, s: pcm.append(np.asarray(s.interleaved).copy()))
    steps = 0
    while not m.done:
        m.decode(1.0 / 30.0)
        steps += 1
        assert steps < 5000, "decode loop did not terminate"
    return frames, pcm


def test_native_player_emits_without_a_dense_plan(short_ps, no_dense_plan):
    """MPEG over a PS, decode(1/30) with both callbacks on the native
    pipeline: no dense plan built, one native blob a picture, and every
    frame and PCM frame equal to the JAX MPEG's."""
    from mpeg_tpu_torch.utils import profiling
    m = tmpeg.MPEG(short_ps, device="cpu")
    assert m._pipeline is not None
    with profiling.collect() as col:
        frames, pcm = _player_output(m)
    want_frames, want_pcm = _player_output(
        jmpeg.MPEG(short_ps, backend="numpy"))
    assert len(frames) == len(want_frames) > 30
    assert frames == want_frames
    assert len(pcm) == len(want_pcm) > 30
    for i, (a, b) in enumerate(zip(pcm, want_pcm)):
        np.testing.assert_array_equal(a, b, err_msg=f"audio frame {i}")
    pictures = sum(1 for sp in col.spans if sp[1] == "mpeg.video.reconstruct")
    assert col.counts["native_picture_blobs"] == pictures >= len(frames)


def test_prepared_picture_dropped_by_seek(short_ps):
    """A seek between a picture's prepare and its emit: the pipeline's
    reset drops the prepared picture, and the seek lands on the frame and
    the samples of a fresh decoder's seek."""
    def seek_output(prepare: bool):
        m = tmpeg.MPEG(short_ps, device="cpu")
        for _ in range(4):
            m.decode_video()
        if prepare:
            assert m.video_decoder._native_next_plan() is not None
        f = m.seek_frame(0.5, True)
        return f.time, f.y.copy(), f.cr.copy(), m.decode_audio().interleaved

    got, want = seek_output(True), seek_output(False)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def _ps_digests(m) -> tuple:
    """(frames, video hash) over decode_video, then (frames, audio hash)
    over decode_audio of a fresh MPEG of the same source."""
    vh, n = Fnv1a64(), 0
    m.set_audio_enabled(False)
    while (f := m.decode_video()) is not None:
        vh.write(f.y.tobytes())
        vh.write(f.cb.tobytes())
        vh.write(f.cr.tobytes())
        n += 1
    return n, vh.sum64()


def _audio_digest(m) -> tuple:
    ah, n = Fnv1a64(), 0
    m.set_video_enabled(False)
    while (s := m.decode_audio()) is not None:
        ah.write(s.interleaved.astype("<f4").tobytes())
        n += 1
    return n, ah.sum64()


def test_ps_digests_match_jax(mpg_path):
    """test.mpg through MPEG.decode_video and decode_audio: equal to the
    JAX MPEG(backend="numpy") and to the pinned constants."""
    jax_video = _ps_digests(jmpeg.MPEG(open(mpg_path, "rb"),
                                       backend="numpy"))
    jax_audio = _audio_digest(jmpeg.MPEG(open(mpg_path, "rb"),
                                         backend="numpy"))
    assert jax_video == GOLDEN_PS_VIDEO
    assert jax_audio == GOLDEN_PS_AUDIO
    assert _ps_digests(new_mpeg(mpg_path)) == jax_video
    assert _audio_digest(new_mpeg(mpg_path)) == jax_audio


def test_python_parser_matches_native(mpg_path):
    """The Python demux-and-parse engine (packets routed through push
    buffers) gives the native pipeline's frames and samples."""
    engines = [new_mpeg(mpg_path, config=tmpeg.Config(parser=p))
               for p in ("python", "native")]
    assert engines[0]._pipeline is None
    assert engines[1]._pipeline is not None
    for _ in range(20):
        f = [m.decode_video() for m in engines]
        np.testing.assert_array_equal(f[0].y, f[1].y)
        np.testing.assert_array_equal(f[0].cr, f[1].cr)
        s = [m.decode_audio() for m in engines]
        np.testing.assert_array_equal(s[0].interleaved, s[1].interleaved)


def _full_decode_digest(m):
    """Clock-driven full decode; (video hash, audio hash, frames,
    audio frames) over everything the callbacks saw."""
    vh, ah = Fnv1a64(), Fnv1a64()
    counts = [0, 0]

    def on_video(_m, f):
        vh.write(f.y.tobytes())
        vh.write(f.cb.tobytes())
        vh.write(f.cr.tobytes())
        counts[0] += 1

    def on_audio(_m, s):
        ah.write(s.interleaved.astype("<f4").tobytes())
        counts[1] += 1

    m.set_video_callback(on_video)
    m.set_audio_callback(on_audio)
    steps = 0
    while not m.done:
        m.decode(1.0 / 30.0)
        steps += 1
        assert steps < 5000, "decode loop did not terminate"
    return vh.sum64(), ah.sum64(), counts[0], counts[1]


class _NoSeekReader:
    """Non-seekable (single-pass) reader: the TeeFeeder engine."""

    def __init__(self, f):
        self._f = f

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False


def test_native_pipeline_seekable_and_push_fed(mpg_path, monkeypatch):
    """decode(tick) with both callbacks: zero Python packet routing on
    the native pipeline, the goldens on a seekable source and the same
    output from a non-seekable one whose control window (capped below
    the stream's size) stops growing; seek and rewind degrade as the
    reference's do on such sources (seekable-only)."""
    def boom(*_a, **_k):
        raise AssertionError("Python packet routing on the native hot path")

    m = new_mpeg(mpg_path)
    monkeypatch.setattr(m, "_read_packets", boom)
    vhash, ahash, nv, na = _full_decode_digest(m)
    assert (nv, vhash) == GOLDEN_PS_VIDEO and (na, ahash) == GOLDEN_PS_AUDIO
    assert m.video_buffer is None and m.audio_buffer is None
    m.rewind()
    assert m.seek(3.0, True)

    data = open(mpg_path, "rb").read()
    cap = 128 << 10
    m = tmpeg.MPEG(_NoSeekReader(io.BytesIO(data)), device="cpu")
    assert m._pipeline is not None and not m._seekable
    m._feeder.control_cap = cap
    monkeypatch.setattr(m, "_read_packets", boom)
    assert m.has_headers()
    assert (m.width(), m.height(), m.samplerate()) == (160, 120, 44100)
    assert _full_decode_digest(m) == (vhash, ahash, nv, na)
    assert m._feeder.pos == len(data)
    assert len(m.demux.buf.bytes()) <= cap + (128 << 10)
    assert m.seek_frame(3.0, True) is None
    assert not m.seek(3.0, False)
    m.rewind()   # clock-only; must not blow up or re-read
    assert m.decode_video() is None   # stream is exhausted


def test_native_demuxer_matches_python_demux(mpg_path):
    """The port's NativeDemuxer binding gives its Python Demux's packets:
    type, PTS and payload bytes, packet for packet."""
    from mpeg_tpu_torch.demux import Demux
    from mpeg_tpu_torch.native import NativeDemuxer

    nat = NativeDemuxer(open(mpg_path, "rb").read())
    assert nat.has_headers()
    buf = tmpeg.Buffer(open(mpg_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    py = Demux(buf)
    assert nat.get_num_video_streams() == py.get_num_video_streams() == 1
    assert nat.get_num_audio_streams() == py.get_num_audio_streams() == 1
    n = 0
    while (a := nat.decode()) is not None:
        b = py.decode()
        assert (a[0], a[1], a[2]) == (b.type, b.pts, bytes(b.data)), n
        n += 1
    assert py.decode() is None and n > 100
