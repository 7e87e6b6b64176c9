"""The port's multi-device stream decode (`parallel.sharding`) on a mesh of
repeated CPU devices, against the JAX package's on its virtual CPU
devices (tests/conftest.py gives it 8).  Tolerance: exact equality of
every displayed frame, carry frame and f32 sample bit, and of the counts."""

import numpy as np
import pytest
import torch

import mpeg_tpu as mpeg
from mpeg_tpu.parallel import sharding as jsh
from mpeg_tpu.parallel.batch import count_pool_records, pool_bucket
from mpeg_tpu.utils import Fnv1a64
from mpeg_tpu_torch.ops import filterbank
from mpeg_tpu_torch.parallel import sharding as sh
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F
PICTURE_TYPE_B = 3


def _videos(path, n):
    videos = []
    for _ in range(n):
        buf = mpeg.Buffer(open(path, "rb"))
        buf.set_load_callback(buf.load_reader_callback)
        videos.append(mpeg.Video(buf, backend="plan"))
    return videos


def _windows(videos, window, count, short=()):
    """`count` windows of plans a stream; in the last window, the streams
    in `short` stop one picture early (their step pads with a no-op)."""
    out = []
    for w in range(count):
        per_stream = []
        for s, v in enumerate(videos):
            want = window - (s in short and w == count - 1)
            per_stream.append([v.parse_next_plan() for _ in range(want)])
        out.append(per_stream)
    return out


@pytest.mark.parametrize("transport", ["blob", "dense"])
def test_sharded_decoders_match_jax(transport, mpeg1video_path):
    """Three windows of 4 streams (two of them a picture short in the last
    window) over a 4-device mesh: displays, carry and total_px equal."""
    import jax

    n, window = 4, 4
    videos = _videos(mpeg1video_path, n)
    geom = videos[0].geom
    windows = _windows(videos, window, 3, short=(1, 3))
    jmesh = jsh.make_mesh(jax.devices()[:n])
    mesh = sh.make_mesh(["cpu"] * n)
    assert mesh.devices == (torch.device("cpu"),) * n
    if transport == "blob":
        nm = max(count_pool_records(p)[0] for w in windows for p in w)
        km = pool_bucket(nm, 4096)
        jdec = jsh.make_sharded_blob_decoder(geom, jmesh, window, km, 64)
        dec = sh.make_sharded_blob_decoder(geom, mesh, window, km, 64)
    else:
        jdec = jsh.make_sharded_scan_decoder(geom, jmesh)
        dec = sh.make_sharded_scan_decoder(geom, mesh)
    jcarry = jsh.zero_carry(geom, n, jmesh)
    carry = sh.zero_carry(geom, n, mesh)
    assert all(len(c) == n and c[0].shape == (1, geom.total_size)
               for c in carry)
    for per_stream in windows:
        if transport == "blob":
            jin = jsh.stack_stream_blobs(per_stream, geom, window, km, 64)
            tin = sh.stack_stream_blobs(per_stream, geom, window, km, 64)
            np.testing.assert_array_equal(tin, jin)
        else:
            jin = jsh.stack_stream_plans(per_stream, geom, window)
            tin = sh.stack_stream_plans(per_stream, geom, window)
            for k in jin:
                np.testing.assert_array_equal(tin[k], jin[k], err_msg=k)
        jcarry, jdisps, jpx = jdec(jcarry, jin)
        carry, disps, px = dec(carry, tin)
        np.testing.assert_array_equal(torch.cat(disps).numpy(),
                                      np.asarray(jdisps))
        for a, b in zip(carry, jcarry):
            np.testing.assert_array_equal(torch.cat(a).numpy(),
                                          np.asarray(b))
        assert px.dtype == torch.int64 and int(px) == int(jpx) == \
            sum(len(p) for p in per_stream) * geom.frame_size


def test_sharded_blob_decode_golden(mpeg1video_path):
    """The whole fixture on two streams over two shards: every stream on
    the golden hash, the end-of-stream flush from the carry included."""
    n, window = 2, 16
    videos = _videos(mpeg1video_path, n)
    geom = videos[0].geom
    windows = []
    while True:
        per_stream = []
        for v in videos:
            plans = []
            while len(plans) < window and \
                    (item := v.parse_next_plan()) is not None:
                plans.append(item)
            per_stream.append(plans)
        if not any(per_stream):
            break
        windows.append(per_stream)
    km = pool_bucket(max(count_pool_records(p)[0]
                         for w in windows for p in w), 4096)
    mesh = sh.make_mesh(["cpu", "cpu"])
    decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, 64)
    carry = sh.zero_carry(geom, n, mesh)
    hashes = [Fnv1a64() for _ in range(n)]
    counts, has_ref, last_type = [0] * n, [False] * n, [0] * n
    for per_stream in windows:
        carry, disps, px = decode(
            carry, sh.stack_stream_blobs(per_stream, geom, window, km, 64))
        disps = torch.cat(disps).numpy()
        assert int(px) == sum(len(p) for p in per_stream) * geom.frame_size
        for s, plans in enumerate(per_stream):
            for i, (_, t) in enumerate(plans):
                last_type[s] = t
                if t == PICTURE_TYPE_B or has_ref[s]:
                    hashes[s].write(disps[s, i, :geom.frame_size].tobytes())
                    counts[s] += 1
                else:
                    has_ref[s] = True
    bwd = torch.cat(carry[2]).numpy()
    for s in range(n):
        if has_ref[s] and last_type[s] != PICTURE_TYPE_B:
            hashes[s].write(bwd[s, :geom.frame_size].tobytes())
            counts[s] += 1
    assert counts == [260] * n
    assert [h.sum64() for h in hashes] == [GOLDEN_VIDEO_HASH] * n


def test_mesh_devices_and_stream_split(mpeg1video_path):
    geom = _videos(mpeg1video_path, 1)[0].geom
    mesh = sh.make_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split"):
        sh.zero_carry(geom, 4, mesh)
    with pytest.raises(ValueError, match="do not split"):
        sh.zero_audio_hist(4, mesh)
    assert [(a, b) for _, a, b in mesh.split(6)] == [(0, 2), (2, 4), (4, 6)]
    assert mesh.group is None and mesh.axis == "streams"
    with pytest.raises(ValueError):
        sh.make_mesh([])
    if not torch.cuda.is_available():
        for devices in (None, ["cuda"], ["cuda:0", "cuda:0"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                sh.make_mesh(devices)


def _subband_frames(path):
    from mpeg_tpu_torch import native

    p = native.NativeAudioParser(open(path, "rb").read())
    frames = []
    while (f := p.parse_next_frame()) is not None:
        frames.append(f)
    return frames


def test_sharded_audio_synth_matches_jax(mp2_path):
    """Four streams (each its own run of whole frames) over four shards:
    u and the history bit for bit equal to JAX's sharded synthesis, the
    total equal, and the PCM equal to the single-stream synthesis."""
    import jax

    from mpeg_tpu.ops import filterbank as jfb

    n = 4
    frames = _subband_frames(mp2_path)
    samples = np.stack([
        np.asarray(frames[8 * s:8 * s + 8], np.int32).reshape(-1, 2, 32)
        for s in range(n)])                       # [4, 288, 2, 32]
    jmesh = jsh.make_mesh(jax.devices()[:n])
    jsynth = jsh.make_sharded_audio_synth(jmesh)
    mesh = sh.make_mesh(["cpu"] * n)
    synth = sh.make_sharded_audio_synth(mesh)
    jhist = jsh.zero_audio_hist(n, jmesh)
    hist = sh.zero_audio_hist(n, mesh)
    for half in (samples[:, :144], samples[:, 144:]):
        ju, jhist, jtotal = jsynth(half, jhist)
        u, hist, total = synth(half, hist)
        got_u = torch.cat(u).numpy()
        np.testing.assert_array_equal(got_u.view(np.uint32),
                                      np.asarray(ju).view(np.uint32))
        np.testing.assert_array_equal(
            torch.cat(hist).numpy().view(np.uint32),
            np.asarray(jhist).view(np.uint32))
        assert total.dtype == torch.int64
        assert int(total) == int(jtotal) == n * 144 * 32
        for s in range(n):
            pcm = filterbank.finalize(u[s][0])
            np.testing.assert_array_equal(
                pcm.numpy().view(np.uint32),
                jfb.finalize_np(np.asarray(ju)[s]).view(np.uint32))
    one, _ = filterbank.synthesize_window(
        torch.from_numpy(samples[2]),
        torch.zeros((15, 2, 64), dtype=torch.float32))
    np.testing.assert_array_equal(
        filterbank.finalize(one[144:]).numpy(),
        filterbank.finalize(u[2][0]).numpy())


def test_pixel_count_is_int64_past_int32():
    """The reduced pixel count of a call of 700 1080p pictures (more than
    the int32 the JAX package's psum holds: it wraps past about 685) is
    exact in int64, also through a process group's all_reduce."""
    import socket

    import torch.distributed as dist

    frame_1080p = 1920 * 1088 * 3 // 2            # FrameGeometry.frame_size
    n = 700 * frame_1080p
    assert n > 2 ** 31 - 1 and np.int64(n).astype(np.int32) != n
    total = sh._reduce_count(n, sh.make_mesh(["cpu"]))
    assert total.dtype == torch.int64 and int(total) == n
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = sh.make_mesh(["cpu", "cpu"])
        assert mesh.group is not None
        total = sh._reduce_count(n, mesh)
        assert total.dtype == torch.int64 and int(total) == n
    finally:
        dist.destroy_process_group()
