"""Many-stream lockstep video decode on a torch device through ONE global
record chain.

Port of `mpeg_tpu/parallel/multistream.py`.  The host half is the port's
own copy of the JAX package's: the per-stream native parsers filling
disjoint picture slots of one logical S*window-picture window blob, the
two recycled host slots (`_Slot`: pinned on the card, each copied
asynchronously and refilled only once its copies' gate has completed),
the prefetch thread, the per-stream reference delay and end-of-stream
flush.  The fill parses the streams on a pool of threads, each stream's
records into its worker's scratch, and stitches them into the slot byte
for byte as the reference's one-thread fill packs it (`_FillPool`,
`MultiStreamVideoDecoder._fill`).  Per round the device runs:

1-2. one `densify_unpack` over all S*window pictures (the delta chain
   runs across stream boundaries, so the global window is one stream to
   it): K5's three launches on the card;
3. per time step t, one stream-batched K1 launch
   (`ops.cuda_kernels.reconstruct_pictures`) over every stream, or one
   per chunk of S/chunks streams: the JAX version's `lax.map` over a
   `vmap` becomes K1's stream axis;
4. rotation by swapping frame-pool slot indices on the host: every
   stream's carry lives in one pool of 4 frames a stream (current,
   forward, backward and the free frame the next picture is written to),
   and the host, which knows every stream's flags, rotates slot numbers
   instead of selecting full frames;
5. the step's displayed frames gathered into [S, window, total_size]
   (RGBA: [S, window, H, W, 4]).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops import cuda_kernels
from ..ops.color import flat_frame_to_rgba
from ..ops.video_recon import FrameGeometry
from ..tables import PICTURE_TYPE_B, PREMULTIPLIER_MATRIX
from ..utils import profiling
from ._runahead import RunAhead
from .batch import (
    _HOP, _MIN_KE, _MIN_KM, _NB_CLASS_REP, _PLAN_FIELDS, HostRing,
    blob_split, densify_unpack, device_put, host_blob, pool_bucket,
    split_views,
)

_SLOTS = 4   # pool frames a stream: current, forward, backward, free
# Threads that parse a decoder's first fill.  There every parser takes
# its first picture and zero-fills its plan arrays (about 25 MB at
# 1080p), and the page faults of many threads of one process contend in
# the kernel: on an 8-CPU H100 host the first fill of a 64-stream job
# took 1.6-3.0 s of system time on 8 threads, 0.2-0.6 s on 4 and
# 0.3-0.5 s on one, and 4 threads finished it soonest.
_FIRST_FILL_THREADS = 4


def initial_carry(geom: FrameGeometry, n_streams: int, device) -> tuple:
    """(pool, slots): a zeroed frame pool uint8 [4*S, total_size] on
    `device`, and each stream's (current, forward, backward, free) pool
    slots, int64 [S, 4] on the host."""
    pool = torch.zeros((_SLOTS * n_streams, geom.total_size),
                       dtype=torch.uint8, device=device)
    slots = np.arange(_SLOTS * n_streams, dtype=np.int64) \
        .reshape(n_streams, _SLOTS)
    return pool, slots


class GlobalWindowDecoder(nn.Module):
    """Decode one global window of S streams x `window` pictures
    (reference: multistream.py make_global_scan_decoder):
    (carry, meta_esc, main_part, flags) -> (carry, displays).

    carry = (pool, slots) as `initial_carry` makes it; stream s owns
    pictures [s*window, (s+1)*window) of the global window and `flags`
    int32 [S*window] are the blob's per-picture flags (bit0 reference
    picture, bit1 valid).  displays uint8 [S, window, total_size] (RGBA:
    [S, window, H, W, 4]), [s, t] the frame the reference's Decode()
    returns after stream s's picture t.  Each step writes every running
    stream's picture into its free slot of the pool, in place: the pool's
    other frames are never written.
    """

    def __init__(self, geom: FrameGeometry, n_streams: int, window: int,
                 kmg: int, keg: int, chunks: int, emit_rgba: bool = False):
        super().__init__()
        if n_streams % chunks:
            raise ValueError(f"chunks={chunks} does not divide "
                             f"{n_streams} streams")
        self.geom, self.n, self.window = geom, n_streams, window
        self.kmg, self.keg, self.chunks = kmg, keg, chunks
        self.emit_rgba = emit_rgba
        self.register_buffer("premult", torch.tensor(
            PREMULTIPLIER_MATRIX, dtype=torch.int32), persistent=False)
        self.register_buffer("nb_class_rep", torch.tensor(
            _NB_CLASS_REP, dtype=torch.int32), persistent=False)
        self._staging = None   # HostRing of the pool's device

    def to_device(self, device, *arrays) -> list:
        """Host arrays (step tables, slot indices) on `device`, copied
        asynchronously through this decoder's `HostRing`."""
        if self._staging is None or self._staging.device != device:
            self._staging = HostRing(device)
        return self._staging.put(arrays)

    def step_tables(self, slots: np.ndarray, flags: np.ndarray):
        """The round's K1 tables on the host: (table int32 [window, S, 5],
        display slots int64 [window, S], slots after the round)."""
        s_n, w_n = self.n, self.window
        fl = np.asarray(flags).reshape(s_n, w_n)
        slots = slots.copy()
        table = np.empty((w_n, s_n, 5), np.int32)
        disp = np.empty((w_n, s_n), np.int64)
        for s in range(s_n):
            cur, fwd, bwd, free = slots[s]
            for t in range(w_n):
                is_ref, run = fl[s, t] & 1, fl[s, t] & 2
                # A reference picture's forward aliases backward; a
                # padding step runs nothing and the carry stays.
                table[t, s] = (cur, bwd if is_ref else fwd, bwd, free,
                               s * w_n + t if run else -1)
                disp[t, s] = bwd if is_ref else (free if run else cur)
                if run and is_ref:
                    cur, fwd, bwd, free = fwd, bwd, free, cur
                elif run:
                    cur, free = free, cur
            slots[s] = (cur, fwd, bwd, free)
        return table, disp, slots

    def forward(self, carry, meta_esc, main_part, flags):
        coeffs, meta = densify_unpack(meta_esc, main_part, self.geom,
                                      self.n * self.window, self.kmg,
                                      self.keg, self.premult,
                                      self.nb_class_rep)
        return self.reconstruct(
            carry, [coeffs, *(meta[k] for k in _PLAN_FIELDS)], flags)

    def reconstruct(self, carry, plan, flags):
        """The window's picture steps from its plan tensors: `plan` is
        (coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v) with a leading
        axis of S*window pictures, stream s's at [s*window, (s+1)*window)
        (what `forward` densifies and unpacks from the global blob, or the
        sharded decoder from each stream's own blob).  Returns (carry,
        displays) as `forward` does."""
        geom = self.geom
        pool, slots = carry
        dev = pool.device
        table, disp, slots = self.step_tables(slots, flags)
        dev_table, dev_disp = self.to_device(dev, table, disp)

        shape = (geom.height, geom.width, 4) if self.emit_rgba \
            else (geom.total_size,)
        disps = torch.empty((self.window, self.n, *shape),
                            dtype=torch.uint8, device=dev)
        per = self.n // self.chunks
        for t in range(self.window):
            for c in range(0, self.n, per):
                if (table[t, c:c + per, 4] >= 0).any():
                    cuda_kernels.reconstruct_pictures(
                        pool, dev_table[t, c:c + per], *plan, geom)
            # Gathered per step: a displayed frame's slot may be the free
            # slot the next step writes.
            if self.emit_rgba:
                disps[t] = flat_frame_to_rgba(pool[dev_disp[t]], geom)
            else:
                torch.index_select(pool, 0, dev_disp[t], out=disps[t])
        return (pool, slots), disps.transpose(0, 1)


class _Slot:
    """One recycled host buffer pair + its pad high-water marks and its
    device gate (reference: mpeg_tpu/parallel/multistream.py _Slot).  The
    buffers are `host_blob`s (pinned for the card): `meta_host` and
    `main_host` own them, `meta` and `main` are their numpy views, which
    the native parser fills."""

    __slots__ = ("meta_host", "main_host", "meta", "main", "views", "types",
                 "hwm", "evt", "gate")

    def __init__(self, geom, gw, kmg, keg, device):
        self.meta_host = host_blob(blob_split(geom, gw, kmg, keg), device)
        self.main_host = host_blob(4 * kmg, device)
        self.meta = self.meta_host.numpy()
        self.main = self.main_host.numpy()
        self.views = split_views(self.meta, self.main, geom, gw, kmg, keg)
        self.types = np.empty(gw, np.int32)
        self.hwm = (kmg, keg)   # fresh: pad the full capacity once
        # Hand-back event: cleared when the filler hands the slot to the
        # consumer, set by the consumer after it has enqueued its copies
        # and stored their gate (or when it decides not to dispatch), so
        # a prefetching filler never refills a slot the consumer still
        # reads.
        self.evt = threading.Event()
        self.evt.set()
        # The gate of the copies that read the buffers last (`device_put`;
        # None: no copy in flight).
        self.gate = None

    def wait(self, closed) -> None:
        """Block until the consumer has handed the slot back and its
        copies have read the buffers (the gate); `closed()` true raises."""
        with profiling.span("mpeg.slot.wait"):
            while not self.evt.wait(timeout=0.5):
                if closed():
                    raise RuntimeError("decoder closed")
        if self.gate is not None:
            profiling.count("blocks")
            with profiling.span("mpeg.block"):
                self.gate.synchronize()
            self.gate = None


def _physical_cores() -> int:
    """The physical cores among the CPUs this process may run on (its
    affinity), from the kernel's CPU topology; a logical CPU whose
    topology cannot be read counts as a core of its own."""
    try:
        cpus = os.sched_getaffinity(0)
    except AttributeError:   # no affinity call on this platform
        return os.cpu_count() or 1
    cores = set()
    for c in cpus:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/"
                      "thread_siblings_list") as f:
                cores.add(f.read().strip())
        except OSError:
            cores.add(f"cpu{c}")
    return max(1, len(cores))


class _Task:
    __slots__ = ("fn", "items", "threads", "took", "error")

    def __init__(self, fn, n, threads):
        self.fn = fn
        self.items = iter(range(n))   # next() holds the GIL: each item once
        self.threads = threads        # workers 0 .. threads-1 take items
        self.took = 0                 # threads that ran an item
        self.error = None


class _FillPool:
    """`threads` daemon threads that run a task's items beside the thread
    that calls `run`.  Each idle thread takes the next item, so streams
    that cost more (I-pictures) spread over the threads.  Idle threads
    block on a condition and never spin.  The threads hold no reference
    to the decoder between tasks; `close` stops and joins them."""

    def __init__(self, threads: int):
        lock = threading.Lock()
        self._go = threading.Condition(lock)
        self._done = threading.Condition(lock)
        self._task = None
        self._gen = 0
        self._busy = 0
        self._stop = False
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True,
                             name=f"mpeg-fill-{i}")
            for i in range(1, threads + 1)]
        for t in self._threads:
            t.start()

    def run(self, fn, n: int, threads: Optional[int] = None) -> int:
        """fn(worker, item) for each item in range(n), on the calling
        thread (worker 0, which takes item 0) and the pool's threads
        (workers 1...), or on the first `threads` of them; returns once
        every item ran, with the number of threads that ran one.  An
        item's exception is raised here."""
        task = _Task(fn, n, len(self._threads) + 1 if threads is None
                     else threads)
        first = next(task.items, None)
        with self._go:
            self._task = task
            self._busy = len(self._threads)
            self._gen += 1
            self._go.notify_all()
        self._work(task, 0, first)
        with self._done:
            while self._busy:
                self._done.wait()
            self._task = None
        if task.error is not None:
            raise task.error
        return task.took

    def _work(self, task, worker, item):
        if item is None:
            return
        try:
            while item is not None:
                task.fn(worker, item)
                item = next(task.items, None)
        except BaseException as e:   # noqa: BLE001 (raised again by run)
            with self._done:
                task.error = task.error or e
            for _ in task.items:   # the other threads stop taking items
                pass
        with self._done:
            task.took += 1

    def _loop(self, worker):
        seen = 0
        while True:
            with self._go:
                while self._gen == seen and not self._stop:
                    self._go.wait()
                if self._gen == seen:   # stopped, and no task waits for it
                    return
                seen, task = self._gen, self._task
            if worker < task.threads:
                self._work(task, worker, next(task.items, None))
            task = None   # no reference to the task's decoder between tasks
            with self._done:
                self._busy -= 1
                if not self._busy:
                    self._done.notify()

    def close(self) -> None:
        """Stop the threads and join them; later `run` calls run on the
        calling thread alone."""
        with self._go:
            self._stop = True
            self._go.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()
        self._threads = []


class _Scratch:
    """One fill worker's record lanes, reused fill after fill: the
    records of the streams it parsed in the current fill, one stream
    after another, each chain started at its stream's base index."""

    __slots__ = ("main", "esc_didx", "esc_val", "nm", "ne", "lanes", "out")

    def __init__(self):
        self.main = np.empty(0, np.uint16)     # (didx, val) pairs
        self.esc_didx = np.empty(0, np.uint16)
        self.esc_val = np.empty(0, np.int32)
        self.nm = self.ne = 0                  # records filled
        self.lanes = self._addresses()
        self.out = np.zeros(5, np.int64)       # the native window's out

    def _addresses(self):
        return tuple(a.ctypes.data for a in (self.main, self.esc_didx,
                                             self.esc_val))

    def reserve(self, m: int, e: int) -> None:
        """Room for `m` more main and `e` more escape records."""
        if self.nm + m > self.main.size // 2:
            k = pool_bucket(self.nm + m, max(self.main.size, _MIN_KM))
            main = np.empty(2 * k, np.uint16)
            main[:2 * self.nm] = self.main[:2 * self.nm]
            self.main = main
            self.lanes = self._addresses()
        if self.ne + e > self.esc_val.size:
            k = pool_bucket(self.ne + e, max(2 * self.esc_val.size, _MIN_KE))
            didx, val = np.empty(k, np.uint16), np.empty(k, np.int32)
            didx[:self.ne] = self.esc_didx[:self.ne]
            val[:self.ne] = self.esc_val[:self.ne]
            self.esc_didx, self.esc_val = didx, val
            self.lanes = self._addresses()


def _by_address(fn):
    """The native function `fn` (as `native.load()` declares it) called
    with a plain address for each array argument: numpy's checks of its
    nine arrays hold the GIL longer than the call's own set-up, once a
    stream and fill on every worker."""
    proto = ctypes.CFUNCTYPE(fn.restype, *(
        ctypes.c_void_p if issubclass(t, ctypes.c_void_p) else t
        for t in fn.argtypes))
    return proto(ctypes.cast(fn, ctypes.c_void_p).value)


def _hops(gap: int) -> int:
    """Hop records the parser's emit writes before a record `gap` past
    the chain's tail (parser.cpp `emit_m`/`emit_e`)."""
    return 0 if gap <= _HOP else (gap - 1) // _HOP


def _seam(didx, val, n: int, base: int, prev: int):
    """Re-chain a stream's records `didx`/`val`, emitted with the chain's
    tail at `base` and at most `n` records before the first one's
    value, onto a chain whose tail is `prev` (<= base): (hops
    before the first record as emitted, hops before it on the new chain,
    its delta on the new chain).  A record's value is never 0 (the
    parser records no zero coefficient), so the leading value-0 records
    are the first record's hops."""
    lead = np.flatnonzero(val[:n])
    if not lead.size:
        raise RuntimeError("a stream's records hold no coefficient")
    h = int(lead[0])
    gap = base + h * _HOP + int(didx[h]) - prev
    g = _hops(gap)
    return h, g, gap - g * _HOP


def _lane_pictures(didx, val, base: int, span: int, seam) -> dict:
    """A stream's records in one lane, as its worker emitted them (the
    chain started at `base`), by picture: {picture: (records, rows,
    tail)} for each picture with records: its records (the parser's
    pool count), the rows it emitted on the global chain (hops included;
    the first picture's re-chained by `seam`) and the chain's tail after
    it.  A hop row belongs to the record after it."""
    if seam is None:
        return {}
    idx = base + np.cumsum(didx, dtype=np.int64)
    real = np.flatnonzero(val)
    pic = idx[real] // span
    last = np.flatnonzero(np.diff(pic, append=-1))   # each picture's last
    records = np.diff(last, prepend=-1)
    rows = np.diff(real[last] + 1, prepend=0)
    rows[0] += seam[1] - seam[0]
    return dict(zip(pic[last].tolist(), zip(records.tolist(), rows.tolist(),
                                            idx[real[last]].tolist())))


class MultiStreamVideoDecoder:
    """Lockstep decoder for N independent video sources on one torch
    device.  Same per-stream output as
    `mpeg_tpu.parallel.MultiStreamVideoDecoder` (each stream equals its
    solo `BatchVideoDecoder`); displayed frames are flat uint8
    [total_size] tensors on `device` (RGBA with `emit_rgba=True`:
    [H, W, 4]).

    `sources` is a list of byte buffers (raw MPEG-1 ES or MPEG-PS,
    sniffed per stream like BatchVideoDecoder).  decode_window() parses
    `window` pictures from EVERY stream, reconstructs them, and returns a
    list of per-stream display-frame lists ([] for a stream with no
    output this round); it returns None when every stream is done.

    `device` is "cuda" (the default; it raises when no CUDA device is
    present) or "cpu".  On "cuda" each time step of a round is `chunks`
    launches of the stream-batched K1, S/chunks streams each (default ~32
    streams a chunk); on "cpu" the plain version runs.  `recon`: "auto"
    and "pallas" run K1; "xla" has no counterpart in the port and raises
    on a CUDA device (on the CPU every choice runs the plain version).
    `stats` (an optional `DecodeStats`) records per round the parse time
    the round waited for, and the time to enqueue its asynchronous copies
    and its launches.
    """

    def __init__(self, sources: List[bytes], window: int = 2,
                 chunks: int = None, pool_buckets: tuple = None,
                 emit_rgba: bool = False, recon: str = "auto",
                 prefetch: bool = False, *, device="cuda", stats=None):
        from .. import native as native_mod

        self._key = profiling.new_key()
        self.device = resolve_device(device)
        if recon not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown recon {recon!r}")
        if recon == "xla" and self.device.type == "cuda":
            raise ValueError("recon='xla': the port has no XLA "
                             "formulation; 'auto' and 'pallas' run the "
                             "CUDA kernel")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not native_mod.available():
            raise RuntimeError("MultiStreamVideoDecoder needs the native "
                               "parser (global-chain fills are a native-"
                               "window-ABI feature)")
        if not sources:
            raise ValueError("need at least one source")
        self.n = len(sources)
        self.window = window
        self.emit_rgba = emit_rgba
        self.parsers = []
        with profiling.span("mpeg.open", self._key):
            for data in sources:
                with profiling.span("mpeg.open.copy", self._key):
                    data = bytes(data)
                with profiling.span("mpeg.open.parser", self._key):
                    p = native_mod.NativePipeline() \
                        if data[:4] == b"\x00\x00\x01\xBA" \
                        else native_mod.NativeVideoParser()
                    p.feed(data)
                    p.signal_end()
                if not p.has_header():
                    raise ValueError("source without a sequence header")
                self.parsers.append(p)
        self.geom = self.parsers[0].geom()
        for p in self.parsers[1:]:
            if p.geom() != self.geom:
                raise ValueError("all sources must share one geometry")
        if chunks is None:
            # Smallest divisor of n whose chunks hold <= ~32 streams;
            # awkward counts (primes > 32) fall back to ONE wide chunk
            # — a single launch over all streams beats n serial chunks of
            # one stream, which is what divisor-hunting would pick.
            ok = [c for c in range(1, self.n + 1)
                  if self.n % c == 0 and self.n // c <= 32]
            chunks = min(ok)
            if chunks > 1 and self.n // chunks < 8:
                chunks = 1
        else:
            while self.n % chunks:
                chunks += 1   # equal chunks
        self.chunks = chunks
        span = self.n * window * self.geom.mb_size * 6 * 64
        if span >= 2 ** 31:
            raise ValueError(
                f"global dense span {span} overflows the int32 index "
                "cumsum; lower window or split the stream set")
        km, ke = pool_buckets or (_MIN_KM, _MIN_KE)
        self._kmg = pool_bucket(km, _MIN_KM)
        self._keg = pool_bucket(max(ke, 1), _MIN_KE)
        self._slots = None        # lazy: sized at first (possibly grown)
        self._slot_i = 0
        self._carry = None
        self._decode = None
        self._caps = None
        # Per-stream display bookkeeping (reference-delay semantics).
        self._has_ref = [False] * self.n
        self._last_type = [0] * self.n
        self._flushed = [False] * self.n
        # prefetch: parse the next global window on a thread of its own
        # while the device consumes the current one (the two slots let it
        # run exactly one window ahead; None: inline).
        self._runahead = RunAhead(
            self, lambda dec: dec._fill(), lambda item: not item[1].any(),
            1) if prefetch else None
        self._closed = False
        # The fill's workers, the filling thread included: the physical
        # cores this process may run on, at most one a stream (set at the
        # first fill; the pool and each worker's scratch are made then).
        self._parse_workers = None
        self._pool = None
        self._pool_close = None
        self._scratch = None
        self._emit = None   # each parser's window call, by address
        self.stats = stats

    # -- host fill (the reference's body) ------------------------------------

    def _fill(self):
        """Parse one global window; returns (slot, types [S, W], nm,
        caps) — caps pins the (kmg, keg) layout the window was packed
        with, so a prefetching consumer compiles against the right
        shapes even if a LATER window has already grown the sticky
        buckets.

        The fill's workers parse the streams (`_parse_stream`), the
        first fill on at most `_FIRST_FILL_THREADS` of them: each
        stream's records into its worker's scratch, its metadata into
        its own picture slots.  The slot is then packed byte for byte as
        the reference's one-thread fill packs it: `_replay` finds that
        fill's record offsets and pool growths from the streams'
        records, the grown slots are allocated once, and the workers
        copy each stream's records to its offsets (`_stitch`)."""
        with profiling.span("mpeg.parse", self._key):
            gw = self.n * self.window
            closed = lambda: self._closed   # noqa: E731
            if self._slots is None:
                self._slots = [_Slot(self.geom, gw, self._kmg, self._keg,
                                     self.device) for _ in range(2)]
                self._slot_i = 0
            slot = self._slots[self._slot_i]
            # Reuse barrier, two parts: wait until the consumer HANDED the
            # slot back (evt — stored the gate or skipped the dispatch), then
            # on the gate itself: the copies must have read these buffers
            # before the parsers overwrite them.
            slot.wait(closed)
            first = self._pool is None
            if first:
                self._start_workers()
            for sc in self._scratch:
                sc.nm = sc.ne = 0
            parsed = [None] * self.n
            v = slot.views
            meta = tuple(a.ctypes.data for a in (
                v["mv_h"], v["mv_v"], v["nbcls"], v["mbmisc"], v["flags"],
                slot.types))
            profiling.count("parse_workers", self._pool.run(
                functools.partial(self._parse_stream, slot, meta, parsed),
                self.n, _FIRST_FILL_THREADS if first else None))
            seams, nm, ne, caps, growths = self._replay(parsed)
            if growths:
                profiling.count("pool_growths", growths)
                # Every old slot's copies complete before the old layout
                # is dropped.
                for other in self._slots:
                    other.wait(closed)
                self._kmg, self._keg = caps
                old = slot
                self._slots = [_Slot(self.geom, gw, self._kmg, self._keg,
                                     self.device) for _ in range(2)]
                self._slot_i = 0
                slot = self._slots[0]
                for lane in ("flags", "mv_h", "mv_v", "nbcls", "mbmisc"):
                    slot.views[lane][:] = old.views[lane]
                slot.types[:] = old.types
            self._pool.run(functools.partial(self._stitch, slot, parsed,
                                             seams), self.n)
            # Zero the pad tails down from the previous fill (or the full
            # capacity for a fresh slot) — the prefix-transfer contract
            # needs [fill, bucket) to be zero records.
            v = slot.views
            hwm_m, hwm_e = slot.hwm
            if hwm_m > nm:
                slot.main[4 * nm:4 * hwm_m] = 0
            if hwm_e > ne:
                v["esc_didx"][ne:hwm_e] = 0
                v["esc_val"][ne:hwm_e] = 0
            slot.hwm = (nm, ne)
            self._slot_i = (self._slot_i + 1) % len(self._slots)
            slot.evt.clear()   # handed out; the consumer sets it back after
                               # storing the gate (or skipping the dispatch)
            # types is COPIED out: the consumer reads it on the host after
            # it hands the slot back, at which point a prefetch producer
            # may already be refilling the slot's buffers.
            return (slot, slot.types.reshape(self.n, self.window).copy(), nm,
                    (self._kmg, self._keg))

    def _start_workers(self) -> None:
        """At the first fill: the pool, each worker's scratch and each
        parser's window call by address."""
        k = self._parse_workers or min(_physical_cores(), self.n)
        self._parse_workers = k
        self._scratch = [_Scratch() for _ in range(k)]
        self._emit = [_by_address(getattr(p._lib, p._window_fn))
                      for p in self.parsers]
        self._pool = _FillPool(k - 1)
        self._pool_close = weakref.finalize(self, self._pool.close)

    def _parse_stream(self, slot, meta, parsed, worker, s):
        """Parse stream s's pictures of the fill in one native window
        call, as the one-thread fill does, but with its records into
        `worker`'s scratch and both chains started at the stream's base
        index (at or below every index it emits), so that no stream waits
        for the one before it.  Metadata, flags and types go straight to
        the slot's picture slots [s*W, (s+1)*W) (`meta`: the addresses
        of those lanes), which no other stream writes."""
        with profiling.span("mpeg.parse.stream", self._key):
            p, emit, sc = self.parsers[s], self._emit[s], self._scratch[worker]
            mb = self.geom.mb_size
            span = mb * 6 * 64
            w = s * self.window
            tm = te = w * span
            m0, e0 = sc.nm, sc.ne
            out = sc.out
            while True:
                n = emit(p._h, w, (s + 1) * self.window, sc.main.size // 2,
                         sc.esc_val.size, sc.nm, sc.ne, 0, 0, tm, te,
                         *sc.lanes, *meta, mb, out.ctypes.data)
                sc.nm, sc.ne, pending, tm, te = out.tolist()
                w += n
                if not pending:
                    break
                # The scratch is full: room for the pending picture by the
                # native call's own capacity check, then resume at it.
                cm, ce = p.blob_counts()
                end = (w + 1) * span
                sc.reserve(cm + ((end - tm) >> 16) + 2,
                           ce + ((end - te) >> 16) + 2)
            parsed[s] = (worker, m0, sc.nm, e0, sc.ne, tm, te)

    def _replay(self, parsed):
        """The reference's one-thread fill of the `parsed` streams,
        replayed on their records: each stream continues the chains of
        the one before it, and before a picture that would overflow the
        pools (parser.cpp `blob_window_impl`'s capacity check, against
        the serial chains' tails) both buckets grow, as that fill grows
        them.  A stream whose whole window fits the buckets with its
        worst hop bound cannot grow them and is taken whole; the others
        are replayed picture by picture (`_lane_pictures`).  Returns
        (each stream's fill offsets (nm, ne) and its main and escape
        `_seam`s, None where it has no such record), nm, ne, (kmg, keg),
        growths)."""
        span = self.geom.mb_size * 6 * 64
        gw = self.n * self.window
        slack = ((gw * span) >> 16) + gw + 2
        lead = _hops(self.window * span) + 1
        km, ke = self._kmg, self._keg
        nm = ne = pm = pe = growths = 0
        seams = []
        for s, (worker, m0, m1, e0, e1, tm, te) in enumerate(parsed):
            sc = self._scratch[worker]
            base = s * self.window * span
            end = base + self.window * span
            main = (sc.main[2 * m0:2 * m1:2], sc.main[2 * m0 + 1:2 * m1:2])
            esc = (sc.esc_didx[e0:e1], sc.esc_val[e0:e1])
            seam_m = _seam(*main, lead, base, pm) if m1 > m0 else None
            seam_e = _seam(*esc, lead, base, pe) if e1 > e0 else None
            seams.append(((nm, ne), seam_m, seam_e))
            rm = m1 - m0 + (seam_m[1] - seam_m[0] if seam_m else 0)
            re_ = e1 - e0 + (seam_e[1] - seam_e[0] if seam_e else 0)
            if (not rm or nm + rm + ((end - pm) >> 16) + 2 <= km) and \
                    (not re_ or ne + re_ + ((end - pe) >> 16) + 2 <= ke):
                nm, ne = nm + rm, ne + re_
                pm, pe = (tm if rm else pm), (te if re_ else pe)
                continue
            pics_m = _lane_pictures(*main, base, span, seam_m)
            pics_e = _lane_pictures(*esc, base, span, seam_e)
            for w in sorted(pics_m.keys() | pics_e.keys()):
                cm, rm, tm = pics_m.get(w, (0, 0, pm))
                ce, re_, te = pics_e.get(w, (0, 0, pe))
                end = (w + 1) * span
                bm = cm + (((end - pm) >> 16) + 2 if cm else 0)
                be = ce + (((end - pe) >> 16) + 2 if ce else 0)
                while nm + bm > km or ne + be > ke:
                    km = pool_bucket(nm + cm + slack, km)
                    ke = pool_bucket(ne + ce + slack, ke)
                    growths += 1
                nm, ne, pm, pe = nm + rm, ne + re_, tm, te
        return seams, nm, ne, (km, ke), growths

    def _stitch(self, slot, parsed, seams, _worker, s):
        """Copy stream s's records from its worker's scratch to its fill
        offsets in the slot: the first main and escape records with the
        hops and delta of `_replay`'s seams, the rest as emitted."""
        worker, m0, m1, e0, e1, _, _ = parsed[s]
        sc, v = self._scratch[worker], slot.views
        (nm, ne), seam_m, seam_e = seams[s]
        if seam_m is not None:
            h, g, d = seam_m
            dst, a = v["main_rec"], 2 * nm
            dst[a:a + 2 * g:2] = _HOP
            dst[a + 1:a + 2 * g:2] = 0
            a += 2 * g
            dst[a] = d
            dst[a + 1] = sc.main[2 * (m0 + h) + 1]
            rest = sc.main[2 * (m0 + h + 1):2 * m1]
            dst[a + 2:a + 2 + rest.size] = rest
        if seam_e is not None:
            h, g, d = seam_e
            didx, val, b = v["esc_didx"], v["esc_val"], ne
            didx[b:b + g] = _HOP
            val[b:b + g] = 0
            b += g
            didx[b] = d
            val[b] = sc.esc_val[e0 + h]
            n = e1 - e0 - h - 1
            didx[b + 1:b + 1 + n] = sc.esc_didx[e0 + h + 1:e1]
            val[b + 1:b + 1 + n] = sc.esc_val[e0 + h + 1:e1]

    # -- device round --------------------------------------------------------

    def _ensure_device(self, caps):
        if self._decode is not None and self._caps == caps and \
                self._carry is not None:
            return
        profiling.count("state_builds")
        with profiling.span("mpeg.state", self._key):
            if self._decode is None or self._caps != caps:
                self._decode = GlobalWindowDecoder(
                    self.geom, self.n, self.window, caps[0], caps[1],
                    self.chunks, emit_rgba=self.emit_rgba).to(self.device)
                self._caps = caps
            if self._carry is None:
                self._carry = initial_carry(self.geom, self.n, self.device)

    def _next_filled(self):
        """The next parsed global window: from the run-ahead parse, or
        parsed inline."""
        with profiling.span("mpeg.parse.wait", self._key):
            if self._runahead is None:
                return self._fill()
            try:
                item = self._runahead.get()
            except BaseException:
                self._closed = True   # the window parsed ahead is lost
                self._runahead = None
                raise
        if self._runahead.done:
            self._runahead = None   # every stream dry: inline from here on
        return item

    def close(self) -> None:
        """Stop the run-ahead parse (early exits); further
        decode_window() calls return None (it may have parsed one window
        ahead — resuming would skip frames)."""
        self._closed = True   # also unsticks evt.wait loops
        if self._runahead is not None:
            self._runahead.close()
            self._runahead = None
        if self._pool_close is not None:
            self._pool_close()   # the fill's threads, joined

    def decode_window(self) -> Optional[list]:
        """One lockstep round; None when every stream is exhausted."""
        with profiling.span("mpeg.window", self._key):
            if self._closed:
                return None
            t0 = time.perf_counter()
            slot, types, nm, caps = self._next_filled()
            t_parse = time.perf_counter() - t0
            self._ensure_device(caps)
            if not types.any():
                slot.evt.set()   # nothing dispatched; slot reusable as-is
                # All streams dry this round: flush pending reference frames.
                pool, slots = self._carry
                out = [[] for _ in range(self.n)]
                any_flush = False
                for s in range(self.n):
                    if self._has_ref[s] and not self._flushed[s] and \
                            self._last_type[s] != PICTURE_TYPE_B:
                        frame = pool[slots[s, 2]]   # backward
                        out[s] = [flat_frame_to_rgba(frame, self.geom)
                                  if self.emit_rgba else frame.clone()]
                        self._flushed[s] = True
                        any_flush = True
                return out if any_flush else None

            # At least one stream produced pictures this round: both copies
            # (meta+escape, then the main records' bucket) are enqueued on the
            # copy stream and the slot goes back with their gate, on which the
            # filler waits before it writes the slot again.
            t1 = time.perf_counter()
            kt = min(pool_bucket(max(nm, 1), _MIN_KM), caps[0])
            with profiling.span("mpeg.enqueue", self._key):
                with profiling.span("mpeg.h2d", self._key):
                    (meta_esc, main_part), gate = device_put(
                        [slot.meta_host, slot.main_host[:4 * kt]], self.device)
                flags = slot.views["flags"].copy()
                slot.gate = gate
                slot.evt.set()
                with profiling.span("mpeg.launch", self._key):
                    self._carry, disps = self._decode(self._carry, meta_esc,
                                                      main_part, flags)
            if self.stats is not None:
                self.stats.record_window(
                    int(np.count_nonzero(types)),
                    meta_esc.numel() + main_part.numel(), t_parse,
                    time.perf_counter() - t1)

            out = []
            for s in range(self.n):
                frames = []
                for w in range(self.window):
                    t = int(types[s, w])
                    if t == 0:
                        continue
                    self._last_type[s] = t
                    if t == PICTURE_TYPE_B:
                        frames.append(disps[s, w])
                    elif self._has_ref[s]:
                        frames.append(disps[s, w])
                    else:
                        self._has_ref[s] = True
                out.append(frames)
            return out

    def decode_all(self) -> list:
        """Run every stream to completion; returns per-stream frame
        lists in display order."""
        out = [[] for _ in range(self.n)]
        while (got := self.decode_window()) is not None:
            for s, frames in enumerate(got):
                out[s].extend(frames)
        return out
