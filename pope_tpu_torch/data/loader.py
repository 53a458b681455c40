"""Host-side prefetch for the eval driver (port of pope_tpu/data/loader.py's
ThreadedLoader, without JAX).

Reference behavior: pose/pose_utils.py:99-155 `data_prefetcher` overlaps
host loading with device compute. Here a thread (or a pool of them) decodes
and uploads batches ahead of the consumer; the eval driver's `prepare_batch`
issues its host-to-device copies on a copy stream of its own from that
thread (pipeline/runner.py). The JAX package's DevicePrefetcher serves only
the training paths and comes with them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class _Raise:
    """Exception captured on a loader thread, re-raised at the consumer."""

    def __init__(self, exc):
        self.exc = exc


class ThreadedLoader:
    """Pulls items from a (possibly slow, IO-bound) iterator on worker
    threads, preserving order.

    Without `fn` (or with num_workers=1), one producer thread drains the
    source iterator into a bounded queue, applying `fn` inline. With `fn`
    and num_workers>1, worker threads pull items from the source under a
    lock and apply `fn` CONCURRENTLY — results are re-assembled in source
    order. The eval driver defaults to num_workers=1
    (POPE_LOADER_WORKERS)."""

    def __init__(self, make_iter: Callable[[], Iterable], num_workers: int = 2,
                 prefetch: int = 4, fn: Optional[Callable] = None):
        self._make_iter = make_iter
        self._prefetch = prefetch
        self._num_workers = max(1, num_workers)
        self._fn = fn

    def __iter__(self) -> Iterator:
        if self._fn is None or self._num_workers == 1:
            yield from self._single_producer()
        else:
            yield from self._worker_pool()

    def _single_producer(self):
        src = iter(self._make_iter())
        fn = self._fn
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        END = object()

        def producer():
            try:
                for item in src:
                    q.put(item if fn is None else fn(item))
            except BaseException as e:  # surfaced at the consumer, not lost
                q.put(_Raise(e))
            finally:
                q.put(END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is END:
                break
            if isinstance(item, _Raise):
                raise item.exc
            yield item

    def _worker_pool(self):
        src = iter(self._make_iter())
        src_lock = threading.Lock()
        results: dict = {}
        cv = threading.Condition()
        # in-flight budget: results waiting + being computed never exceed
        # prefetch + workers, bounding host/device memory
        budget = threading.Semaphore(self._prefetch + self._num_workers)
        state = {"next_seq": 0, "n_exited": 0}

        def worker():
            while True:
                budget.acquire()
                with src_lock:
                    try:
                        item = next(src)
                        seq = state["next_seq"]
                        state["next_seq"] += 1
                    except BaseException as e:  # StopIteration or source error
                        budget.release()
                        with cv:
                            if not isinstance(e, StopIteration):
                                state["error"] = e
                            state["n_exited"] += 1
                            cv.notify_all()
                        return
                try:
                    out = self._fn(item)
                except BaseException as e:  # surfaced at the consumer, in order
                    out = _Raise(e)
                with cv:
                    results[seq] = out
                    cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self._num_workers)
        ]
        for t in threads:
            t.start()

        nxt = 0
        while True:
            with cv:
                while nxt not in results:
                    # every exited worker has already deposited its last
                    # result, so all-exited + result absent => stream done
                    if state["n_exited"] == len(threads):
                        if "error" in state:
                            raise state["error"]
                        return
                    cv.wait(timeout=0.1)
                out = results.pop(nxt)
            nxt += 1
            budget.release()
            if isinstance(out, _Raise):
                raise out.exc
            yield out
