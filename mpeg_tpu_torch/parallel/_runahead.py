"""The run-ahead parse of the windowed decoders: one thread that parses
the next windows while the decoder's caller consumes the current one.

`BatchVideoDecoder`, `MultiStreamVideoDecoder` and `BatchAudioDecoder`
each own one `RunAhead` when built with `prefetch=True`.  The thread
holds its decoder only through a weak reference, so a decoder dropped
without `close()` is collected and its thread exits within one 0.5 s
poll, a full queue included.  A parse error reaches the consumer in
band, after the items parsed before it.
"""

from __future__ import annotations

import queue
import threading
import traceback
import weakref

_POLL_S = 0.5


class RunAhead:
    """The items `parse(owner)` returns, parsed on a thread of their own
    at most `depth` ahead of `get()`.

    `is_last(item)` marks the last item: the thread exits after parsing
    it, and `get()` sets `done` once it has returned it.  `parse` and
    `is_last` must hold no strong reference to `owner`."""

    def __init__(self, owner, parse, is_last, depth: int):
        self._owner = weakref.ref(owner)
        self._parse = parse
        self._is_last = is_last
        self._queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self.done = False

    def get(self):
        """The next item; the thread starts at the first call.  Raises
        the error the parse raised, in band; after it, and after the
        last item, the thread has exited and `done` is true."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        entry = self._queue.get()
        if isinstance(entry, BaseException):
            self._finish()
            raise entry
        item, last = entry
        if last:
            self._finish()
        return item

    def close(self) -> None:
        """Stop the thread, drop the items parsed ahead and join it."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            self._drain()   # a put that waits for room returns at once
            self._thread.join(timeout=0.1)
        self._drain()
        self.done = True

    def _finish(self) -> None:
        self._thread.join()
        self.done = True

    def _drain(self) -> None:
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def _run(self) -> None:
        while True:
            owner = self._owner()
            if owner is None or self._stop.is_set():
                return
            try:
                item = self._parse(owner)
            except BaseException as e:   # noqa: BLE001 -- in band
                del owner
                # The traceback's frames hold the owner: clear their
                # locals so that the put below cannot keep it alive.
                traceback.clear_frames(e.__traceback__)
                self._put(e)
                return
            del owner   # no strong reference while the put waits
            last = self._is_last(item)
            if not self._put((item, last)) or last:
                return

    def _put(self, entry) -> bool:
        """Put `entry`, polling; False once the thread is stopped or the
        owner collected."""
        while not (self._stop.is_set() or self._owner() is None):
            try:
                self._queue.put(entry, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False
