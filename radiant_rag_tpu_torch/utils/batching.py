"""Cross-request micro-batching for serving.

The port's copy of `RequestCoalescer` from `radiant_rag_tpu/utils/batching.py`,
with its behaviour unchanged. The engine is batched-first: one device pass
over a (B, ...) query batch costs little more than B = 1, so the serving
layer coalesces concurrent requests into one batch instead of serializing
them through a lock (the dynamic-batching pattern of model servers).

RequestCoalescer groups pending items by a compatibility key (e.g. (mode,
top_k)); a single worker drains one group per cycle after a short
accumulation window, runs `run_batch(key, items)` once, and routes per-item
results (or the raised error) back to the blocked callers. With the
two-phase `run_batch_async`, a drain thread resolves dispatched batches
while the worker dispatches the next.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item: Any) -> None:
        self.item = item
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class RequestCoalescer:
    """Blocking submit() -> batched run_batch() -> per-caller results."""

    def __init__(
        self,
        run_batch: Callable[[Hashable, Sequence[Any]], Sequence[Any]],
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        name: str = "coalescer",
        run_batch_async: Optional[Callable[[Hashable, Sequence[Any]],
                                           Callable[[], Sequence[Any]]]] = None,
        pipeline_depth: int = 2,
    ) -> None:
        """run_batch_async, if given, is a two-phase form: it DISPATCHES the
        batch (device work + an asynchronous device->host copy) and
        returns a complete() that blocks for the results. A separate drain
        thread then resolves completed batches while the dispatch thread
        moves on: one batch's device->host fetch overlaps the next batch's
        dispatch (the serving side of `search_rows(fetch=False)`). The
        bounded hand-off queue caps in-flight batches at `pipeline_depth`;
        completed results are never held hostage by a dispatch that blocks
        (e.g. on the server's device lock)."""
        self.run_batch = run_batch
        self.run_batch_async = run_batch_async
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.name = name
        # FIFO of groups; each group is the list of pending items for one key
        self._groups: "OrderedDict[Hashable, List[_Pending]]" = OrderedDict()
        self._cv = threading.Condition()
        self._stopped = False
        self.stats = {"requests": 0, "batches": 0, "max_batch": 0,
                      "pipelined": 0}
        self._drain_q = None
        self._drainer = None
        if run_batch_async is not None:
            import queue as _queue

            self._drain_q = _queue.Queue(maxsize=self.pipeline_depth)
            self._drainer = threading.Thread(target=self._drain_loop,
                                             daemon=True,
                                             name=f"{name}-drain")
            self._drainer.start()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{name}-worker")
        self._worker.start()

    def submit(self, key: Hashable, item: Any, timeout: Optional[float] = None) -> Any:
        """Enqueue one item under `key`; blocks until its batch ran."""
        p = _Pending(item)
        with self._cv:
            if self._stopped:
                raise RuntimeError(f"{self.name} is stopped")
            self._groups.setdefault(key, []).append(p)
            self.stats["requests"] += 1
            self._cv.notify_all()
        if not p.event.wait(timeout):
            raise TimeoutError(f"{self.name}: batch did not complete in {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
        if self._drainer is not None:
            self._drainer.join(timeout=5.0)
        # fail anything still queued
        with self._cv:
            for group in self._groups.values():
                for p in group:
                    p.error = RuntimeError(f"{self.name} stopped")
                    p.event.set()
            self._groups.clear()

    # ------------------------------------------------------------------
    def _take_group(self) -> Optional[tuple]:
        """Pop up to max_batch items of the oldest group (caller holds _cv)."""
        if not self._groups:
            return None
        key, group = next(iter(self._groups.items()))
        batch = group[: self.max_batch]
        rest = group[self.max_batch:]
        if rest:
            self._groups[key] = rest
        else:
            del self._groups[key]
        return key, batch

    def _deliver(self, batch: List[_Pending], results=None,
                 error: Optional[BaseException] = None) -> None:
        if error is None and results is not None and len(results) != len(batch):
            error = RuntimeError(
                f"run_batch returned {len(results)} results for "
                f"{len(batch)} items")
        if error is not None:
            for p in batch:
                p.error = error
        else:
            for p, r in zip(batch, results):
                p.result = r
        self.stats["batches"] += 1
        self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
        for p in batch:
            p.event.set()

    def _drain_loop(self) -> None:
        """Resolve in-flight batches in dispatch order (separate thread, so
        a blocked dispatch never delays already-computed results)."""
        while True:
            got = self._drain_q.get()
            if got is None:  # stop sentinel
                return
            batch, complete = got
            try:
                self._deliver(batch, complete())
            except BaseException as exc:  # noqa: BLE001 — routed to callers
                self._deliver(batch, error=exc)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._groups and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._groups:
                    if self._drain_q is not None:
                        self._drain_q.put(None)  # flush + stop the drainer
                    return
            # accumulation window: let concurrent callers join the batch
            if self.max_wait_s:
                time.sleep(self.max_wait_s)
            with self._cv:
                taken = self._take_group()
            if taken is None:
                continue
            key, batch = taken
            if self.run_batch_async is not None:
                try:
                    complete = self.run_batch_async(key, [p.item for p in batch])
                except BaseException as exc:  # noqa: BLE001
                    self._deliver(batch, error=exc)
                    continue
                if getattr(complete, "pipelined", False):
                    self.stats["pipelined"] += 1
                # blocks when pipeline_depth batches are already in flight
                self._drain_q.put((batch, complete))
                continue
            try:
                self._deliver(batch, self.run_batch(key, [p.item for p in batch]))
            except BaseException as exc:  # noqa: BLE001 — routed to callers
                self._deliver(batch, error=exc)
