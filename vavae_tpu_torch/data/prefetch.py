"""Host-side input pipelining: a bounded background producer (port of
``vavae_tpu/data/prefetch.py``).

A daemon thread runs the producer iterator (image decode and crop: zlib and
numpy release the GIL for the heavy parts) while the consumer feeds the
card. Producer exceptions re-raise in the consumer; abandoning the iterator
stops the producer and closes the source from the producer's thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Run a producer iterator in a background thread with a bounded queue.

    Producer exceptions re-raise in the consumer: a corrupt image aborts the
    run instead of truncating the dataset. If the consumer abandons the
    iterator (an exception in the loop body, an early break, GC), the
    producer is unblocked and the source iterator is closed from the
    producer's own thread, so a generator's ``finally`` (the decode pool's
    shutdown in ``ImageFolderDataset.batches``) runs promptly.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for item in it:
                    if not _put(item):
                        return
                _put(_END)
            except BaseException as e:  # noqa: BLE001 - forwarded to consumer
                _put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # safe: same thread that iterates the generator

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer blocked mid-put unblocks on its next timeout
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
