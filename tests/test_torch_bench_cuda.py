"""The bench leg's headline on the card (`mpeg_tpu_torch.bench`): its
displays equal the port's CPU displays of the same rounds, and a ring
slot is not handed out for writing before the event of the copies that
read it has completed, shown with an adversary that holds the copy
stream (`torch.cuda._sleep`).  Marked `cuda`: each test skips inside its
body without a card (`python -m pytest --noconftest
tests/test_torch_bench_cuda.py -q -m cuda`).  This module imports only
the port.  Tolerance: exact."""

import pathlib
import threading

import pytest
import torch

from mpeg_tpu_torch import bench
from mpeg_tpu_torch.parallel import batch as tb

TESTDATA = pathlib.Path(__file__).parent / "testdata"
ES = TESTDATA / "test.mpeg1video"

pytestmark = pytest.mark.cuda

# About 50 ms of the card's time at its ~2 GHz clock.
HOLD_CYCLES = 100_000_000


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", torch.cuda.current_device())


def _rounds(data, device, window, n, rounds):
    """The headline's displays of `rounds` rounds of `n` looping streams
    from fresh streams and a fresh carry, on the CPU."""
    geom, _, km, ke = bench.discover_buckets(data, window)
    fill, ring = bench.make_window_filler(geom, window, km, ke, n,
                                          device=device)
    head = bench.HeadlineDecoder(geom, window, km, ke, n, ring, device)
    streams = [bench.Stream(data) for _ in range(n)]
    carry, out = head.fresh_carry(), []
    for _ in range(rounds):
        carry, disps = head.decode(carry, head.transfer(fill(streams)))
        out.append(disps.cpu())
    return out


def test_headline_on_the_card_equals_the_cpu():
    """Two rounds of 4 streams at window 16 on the 1080p fixture: every
    display on the card equals the plain versions' on the CPU."""
    dev = _card()
    data = (TESTDATA / "test1080.m1v").read_bytes()
    got = _rounds(data, dev, 16, 4, 2)
    want = _rounds(data, "cpu", 16, 4, 2)
    assert len(got) == len(want) == 2
    for r, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), f"round {r}"


def test_ring_slot_waits_for_its_copy_event():
    """With the copy stream held, a round's copies pend after `transfer`
    hands its slot back; `acquire` returns that slot (a ring of one) only
    once their event has completed."""
    dev = _card()
    data = ES.read_bytes()
    geom, _, km, ke = bench.discover_buckets(data, 4)
    fill, ring = bench.make_window_filler(geom, 4, km, ke, 2, depth=1,
                                          device=dev)
    head = bench.HeadlineDecoder(geom, 4, km, ke, 2, ring, dev)
    streams = [bench.Stream(data) for _ in range(2)]
    filled = fill(streams)
    slot = filled[1]
    assert slot.meta_host.is_pinned() and slot.stage_host.is_pinned()
    torch.cuda.synchronize()
    with torch.cuda.stream(tb.copy_stream(dev)):
        torch.cuda._sleep(HOLD_CYCLES)
    head.transfer(filled)
    gate = slot.gate
    assert gate is not None and not gate.query()   # the copies pend
    got = []
    th = threading.Thread(target=lambda: got.append(
        (ring.acquire(), gate.query())))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert got[0][0] is slot and got[0][1], "handed out before its event"
    assert slot.gate is None
