"""The port's reference-shaped API takes the JAX package's calls as they
are written: `backend` is the second positional parameter of `MPEG`,
`Audio`, `Video`, `PipelineVideo` and `PipelineAudio`, `Config` has a
`backend` field, and the JAX package's "jax" and "numpy" backends raise
`ValueError` everywhere.  The port's `__all__` covers the JAX package's."""

import io

import pytest

import mpeg_tpu
import mpeg_tpu.parallel
import mpeg_tpu_torch as tmpeg
import mpeg_tpu_torch.parallel
from mpeg_tpu_torch.pipeline import PipelineAudio, PipelineVideo
from torch_threads import one_torch_thread  # noqa: F401


def _buffer(path):
    buf = tmpeg.Buffer(open(path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    return buf


def test_config_backend_field():
    cfg = tmpeg.Config()
    assert cfg.backend == "torch"
    assert list(vars(cfg))[0] == "backend"   # the reference's first field
    assert tmpeg.Config("torch", "python").parser == "python"


def test_reference_positional_calls(mpg_path, mp2_path, mpeg1video_path):
    cfg = tmpeg.Config(parser="python")
    m = tmpeg.MPEG(open(mpg_path, "rb"), None, cfg, device="cpu")
    assert (m.backend, m.config) == ("torch", cfg)
    m = tmpeg.MPEG(open(mpg_path, "rb"), "torch", device="cpu")
    assert m.decode_video().y.shape == (128, 160)
    a = tmpeg.Audio(_buffer(mp2_path), None, "python", device="cpu")
    assert (a.backend, a.parser) == ("torch", "python")
    assert a.decode().interleaved.shape == (2304,)
    v = tmpeg.Video(_buffer(mpeg1video_path), "plan", "python")
    assert v.backend == "plan" and v.parse_next_plan() is not None
    v = tmpeg.Video(_buffer(mpeg1video_path), None, None,
                    tmpeg.Config(backend="plan"))
    assert v.backend == "plan"


def test_jax_backends_raise(mpg_path, mp2_path, mpeg1video_path):
    for backend in ("jax", "numpy"):
        for make in (
                lambda: tmpeg.MPEG(open(mpg_path, "rb"), backend,
                                   device="cpu"),
                lambda: tmpeg.MPEG(open(mpg_path, "rb"), None,
                                   tmpeg.Config(backend=backend),
                                   device="cpu"),
                lambda: tmpeg.Audio(_buffer(mp2_path), backend,
                                    device="cpu"),
                lambda: tmpeg.Video(_buffer(mpeg1video_path), backend,
                                    device="cpu"),
                lambda: PipelineVideo(None, None, backend, device="cpu"),
                lambda: PipelineAudio(None, None, backend, device="cpu")):
            with pytest.raises(ValueError, match='device="cpu"'):
                make()
    # "plan" parses video only.
    for make in (lambda: tmpeg.MPEG(open(mpg_path, "rb"), "plan",
                                    device="cpu"),
                 lambda: tmpeg.Audio(tmpeg.Buffer(io.BytesIO(b"")), "plan",
                                     device="cpu")):
        with pytest.raises(ValueError, match="unknown backend"):
            make()


def test_exports_cover_the_jax_package():
    assert set(mpeg_tpu.__all__) <= set(tmpeg.__all__), \
        set(mpeg_tpu.__all__) - set(tmpeg.__all__)
    assert set(mpeg_tpu.parallel.__all__) <= \
        set(mpeg_tpu_torch.parallel.__all__), \
        set(mpeg_tpu.parallel.__all__) - set(mpeg_tpu_torch.parallel.__all__)
    for name in tmpeg.__all__:
        assert getattr(tmpeg, name) is not None, name
    assert tmpeg.BUFFER_SIZE == mpeg_tpu.BUFFER_SIZE
    assert tmpeg.PACKET_VIDEO_1 == mpeg_tpu.PACKET_VIDEO_1 == 0xE0
