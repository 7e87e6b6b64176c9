"""The run-ahead parse (`prefetch=True`) of the port's three windowed
decoders on the CPU: `close()` mid-stream, a parse error, an abandoned
decoder and the end of the stream, each for `BatchVideoDecoder`,
`MultiStreamVideoDecoder` and `BatchAudioDecoder`; and the stage itself
(`parallel._runahead.RunAhead`) on a fake parse."""

import gc
import pathlib
import time
import weakref

import numpy as np
import pytest
import torch

from mpeg_tpu_torch import native
from mpeg_tpu_torch.parallel import (BatchAudioDecoder, BatchVideoDecoder,
                                     MultiStreamVideoDecoder)
from mpeg_tpu_torch.parallel._runahead import RunAhead
from torch_threads import one_torch_thread  # noqa: F401

TESTDATA = pathlib.Path(__file__).parent / "testdata"
ES = (TESTDATA / "test.mpeg1video").read_bytes()
# 72 frames of the broadcast MP2: windows of 16, 16, 16, 16 and 8 frames.
MP2 = (TESTDATA / "mp2_48k_joint_256.mp2").read_bytes()[:72 * 768]


def _batch(prefetch=True):
    return BatchVideoDecoder(ES[:40000], window=4, prefetch=prefetch,
                             device="cpu")


def _multistream(prefetch=True):
    if not native.available():
        pytest.skip("needs the native parser")
    return MultiStreamVideoDecoder([ES[:30000], ES[:20000]], window=2,
                                   prefetch=prefetch, device="cpu")


def _audio(prefetch=True):
    return BatchAudioDecoder(MP2, window=16, prefetch=prefetch,
                             device="cpu")


# Each decoder: its constructor, the name of the parse the run-ahead
# calls, and what decode_window() returns after the end or a close().
DECODERS = {
    "batch": (_batch, "_parse_stage", []),
    "multistream": (_multistream, "_fill", None),
    "audio": (_audio, "_parse_window", None),
}


def _flat(window):
    """One decode_window() result as comparable bytes."""
    if isinstance(window, np.ndarray):
        return [window.tobytes()]
    if isinstance(window, torch.Tensor):
        return [window.numpy().tobytes()]
    return [b for part in window for b in _flat(part)]


def _ended(window):
    """decode_window()'s end of stream: [] or None."""
    return window is None or (isinstance(window, list) and not window)


def _stage_thread(dec):
    return dec._runahead._thread


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_close_mid_stream_joins_the_thread(kind):
    make, _, end = DECODERS[kind]
    dec = make()
    assert not _ended(dec.decode_window())
    thread = _stage_thread(dec)
    assert thread.is_alive()          # parsing ahead, or waiting for room
    dec.close()
    assert not thread.is_alive()
    assert dec.decode_window() == end
    assert dec.decode_window() == end


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_a_parse_error_arrives_after_the_windows_parsed_before_it(kind):
    make, parse_name, end = DECODERS[kind]
    inline = make(prefetch=False)
    want = [_flat(inline.decode_window()) for _ in range(2)]

    dec = make()
    parse = getattr(dec, parse_name)
    calls = []

    def failing():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("parse failed")
        return parse()

    setattr(dec, parse_name, failing)
    got = [_flat(dec.decode_window()) for _ in range(2)]
    assert got == want
    thread = _stage_thread(dec)
    with pytest.raises(RuntimeError, match="parse failed"):
        dec.decode_window()
    assert not thread.is_alive() and len(calls) == 3
    assert dec.decode_window() == end
    dec.close()
    assert dec.decode_window() == end


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_an_abandoned_decoder_is_collected_and_its_thread_exits(kind):
    make, _, _ = DECODERS[kind]
    dec = make()
    assert not _ended(dec.decode_window())
    thread = _stage_thread(dec)
    ref = weakref.ref(dec)
    del dec
    deadline = time.monotonic() + 5
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()              # the thread may still hold it mid-parse
        time.sleep(0.05)
    assert ref() is None
    thread.join(timeout=5)
    assert not thread.is_alive()


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_the_thread_has_exited_once_the_last_window_is_returned(kind):
    make, _, end = DECODERS[kind]
    inline = make(prefetch=False)
    want = []
    while not _ended(w := inline.decode_window()):
        want.append(_flat(w))

    dec = make()
    got = [_flat(dec.decode_window())]
    stage = dec._runahead
    while dec._runahead is not None:
        if not _ended(w := dec.decode_window()):
            got.append(_flat(w))
    assert stage.done and not stage._thread.is_alive()
    while not _ended(w := dec.decode_window()):   # parsed inline
        got.append(_flat(w))
    assert got == want
    assert dec.decode_window() == end


class _Owner:
    parsed = 0


def _count(owner):
    owner.parsed += 1
    return owner.parsed


@pytest.mark.parametrize("depth", [1, 2])
def test_the_stage_parses_at_most_depth_ahead(depth):
    owner = _Owner()
    stage = RunAhead(owner, _count, lambda item: item == 10, depth)
    for k in range(1, 11):
        assert stage.get() == k
        # The queue holds `depth` items and the thread one more, parsed
        # and waiting for room.
        ahead = min(k + depth + 1, 10)
        deadline = time.monotonic() + 5
        while owner.parsed < ahead and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.02)
        assert owner.parsed == ahead
    assert stage.done and not stage._thread.is_alive()


def test_the_stage_delivers_an_error_in_band_and_close_is_idempotent():
    owner = _Owner()

    def parse(o):
        o.parsed += 1
        if o.parsed == 3:
            raise ValueError("bad window")
        return o.parsed

    stage = RunAhead(owner, parse, lambda item: False, 2)
    assert [stage.get(), stage.get()] == [1, 2]
    with pytest.raises(ValueError, match="bad window"):
        stage.get()
    assert stage.done and not stage._thread.is_alive()
    stage.close()
    stage.close()
    unstarted = RunAhead(owner, parse, lambda item: False, 2)
    unstarted.close()
    assert unstarted.done and unstarted._thread is None


def test_a_failed_parse_waiting_for_room_does_not_pin_its_owner():
    owner = _Owner()

    def parse(o):
        o.parsed += 1
        if o.parsed == 3:
            raise ValueError("bad window")
        return o.parsed

    stage = RunAhead(owner, parse, lambda item: False, 1)
    assert stage.get() == 1
    deadline = time.monotonic() + 5
    while owner.parsed < 3 and time.monotonic() < deadline:
        time.sleep(0.001)     # item 2 queued, the error waits for room
    ref = weakref.ref(owner)
    del owner
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert ref() is None
    stage._thread.join(timeout=5)
    assert not stage._thread.is_alive()
