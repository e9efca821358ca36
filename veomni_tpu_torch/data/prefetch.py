"""Background host-batch prefetch (copy of ``veomni_tpu/data/prefetch.py``, which
imports no JAX; the port keeps its own copy). In the port the H2D copy stays
in the trainer's ``_ship_batch`` (pinned host tensor, asynchronous copy to
the card); this thread assembles host batches only.

Reference capability: ``veomni/trainer/base.py:97-199`` (BackgroundPrefetcher
/ VeOmniIter — batch assembly on a worker thread, overlapped with the device
step) and the non-blocking H2D transfers at ``:681-703``. On TPU the H2D
overlap is free (``device_put`` dispatches asynchronously); what still costs
wall-clock is the *host-side* work — tokenize/pack/collate — which this
thread hides behind device compute.

Checkpoint contract: the loader cursor saved in a checkpoint must describe
the last batch the *trainer consumed*, not the last one the thread pulled
(the thread runs ahead by ``depth`` batches; saving its cursor would skip
those batches on resume). ``state_dict()`` therefore returns the snapshot
captured right after the consumed batch was pulled from the underlying
loader.

Failure contract (resilience subsystem): a worker-thread exception is
re-raised to the consumer WITH the worker's original traceback (the frames
that actually failed — not a bare sentinel ending iteration); ``close()`` is
idempotent and signal-handler-safe, and a consumer blocked on the queue wakes
with :class:`PrefetcherClosed` instead of absorbing a preemption deadline.

Threading contract (lock-discipline audit, docs/static-analysis.md): this
module deliberately has NO lock-guarded state, so it carries no
``# guarded-by:`` annotations. Worker→consumer handoff is the internally
locked ``queue.Queue``; ``_stop`` is a ``threading.Event``; ``_closed`` is
a write-once bool latch whose racy read path is re-checked each loop
iteration; ``_consumed_state``/``_finished`` are touched only by the
consumer thread.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional

from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.resilience.faults import fault_point

_SENTINEL = object()


def _snapshot(state: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Deep copy of a loader cursor snapshot. The worker thread keeps
    iterating (and the loader keeps mutating its internal maps — e.g. the
    streaming dataset's globally-keyed ``consumed`` table) after the
    snapshot is taken; a shared reference would let run-ahead contaminate
    the cursor a checkpoint later serializes, silently breaking both exact
    resume and the elastic merge that trusts per-rank snapshots to be
    mutually consistent."""
    return copy.deepcopy(state) if state is not None else None


class PrefetcherClosed(RuntimeError):
    """Raised to a consumer blocked on / arriving after ``close()`` (the
    graceful-shutdown signal handler closes the prefetcher to unblock the
    train loop)."""


class BackgroundPrefetcher:
    """Iterates ``dataloader`` on a daemon thread, ``depth`` batches ahead.

    Propagates the underlying iterator's exceptions (incl. StopIteration) at
    the point of consumption. ``close()`` stops the thread; it is also safe
    to simply drop the object (daemon thread, bounded queue).
    """

    def __init__(self, dataloader, depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.dataloader = dataloader
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._consumed_state: Optional[Dict[str, Any]] = _snapshot(
            dataloader.state_dict() if hasattr(dataloader, "state_dict") else None
        )
        self._finished: Optional[BaseException | type] = None
        # observability: queue fill tells whether the pipeline runs ahead
        # (healthy: ~depth) or the trainer is starved (0 + growing waits)
        reg = get_registry()
        self._m_depth = reg.gauge("data.prefetch_queue_depth")
        self._m_wait = reg.histogram("data.prefetch_wait_s")
        self._thread = threading.Thread(
            target=self._worker, name="veomni-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False if the consumer went away."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            it = iter(self.dataloader)
            while True:
                # deterministic injection site for the whole host data path
                # (any dataloader type, not just streaming shards)
                fault_point("data.fetch")
                try:
                    batch = next(it)
                except StopIteration:
                    break
                snap = _snapshot(
                    self.dataloader.state_dict()
                    if hasattr(self.dataloader, "state_dict")
                    else None
                )
                if not self._put((batch, snap, None)):
                    return
            self._put((_SENTINEL, None, None))
        except BaseException as e:  # surface worker errors to the consumer
            self._put((_SENTINEL, None, e))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished is not None:  # latch: exhausted iterators stay so
            if self._finished is not StopIteration:
                raise self._finished
            raise StopIteration
        t_wait = time.perf_counter()
        while True:
            if self._closed:
                raise PrefetcherClosed("prefetcher closed while awaiting a batch")
            try:
                # bounded wait, NOT a bare get(): a signal handler that runs
                # while the main thread is blocked here can only set flags —
                # the timeout is what turns the flag into a wakeup
                batch, snap, err = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if batch is _SENTINEL:
            self._finished = err if err is not None else StopIteration
            if err is not None:
                # re-raising the worker's exception object keeps its
                # __traceback__ — the consumer sees the worker-side frames
                # where the data pipeline actually failed. Data-integrity
                # failures (poison-skip budget exhaustion) additionally get
                # the last CONSUMED loader cursor pinned on: the worker ran
                # ahead of the trainer, so its own state is NOT where a
                # resumed run would restart from.
                from veomni_tpu_torch.resilience.integrity import ShardRecordError

                if isinstance(err, ShardRecordError):
                    note = (
                        f"last consumed dataloader cursor: {self._consumed_state}"
                    )
                    if hasattr(err, "add_note"):  # py3.11+
                        err.add_note(note)
                    else:  # pragma: no cover - older interpreters
                        import logging

                        logging.getLogger(__name__).error(note)
                raise err
            raise StopIteration
        self._m_wait.observe(time.perf_counter() - t_wait)
        self._m_depth.set(self._queue.qsize())
        self._consumed_state = snap
        return batch

    def state_dict(self) -> Optional[Dict[str, Any]]:
        return self._consumed_state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        raise RuntimeError(
            "restore the underlying dataloader BEFORE constructing the "
            "prefetcher (the thread starts pulling at construction)"
        )

    def close(self):
        """Idempotent; safe to call from a signal handler (flag sets + a
        non-blocking drain; the join is bounded)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # unblock a worker stuck on put() by draining one slot
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
