"""Training observability: EnvironMeter (MFU, tokens/sec) + misc helpers.

Port of ``veomni_tpu/utils/helper.py``. What changes against the reference:
``set_seed`` returns a ``torch.Generator`` (and seeds numpy, Python and
torch) instead of a PRNG key; the meter's MFU denominator is the card's
published peak (``utils/device.py``), and a CPU run, which has no published
peak, reports throughput without MFU; ``live_memory_stats`` reads
``torch.cuda.memory_stats``. ``Watchdog``, ``dump_thread_stacks``,
``host_floats`` and the host-RSS reader are the reference's, unchanged;
``enable_full_determinism`` lives in ``utils/determinism.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from veomni_tpu_torch.utils.count_flops import FlopsCounter
from veomni_tpu_torch.utils.device import get_device_peak_flops
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class EnvironMeter:
    """Accumulates per-step tokens/FLOPs and derives MFU + throughput.

    At world size 1 the batch stats are global already; over a mesh each
    rank adds its own batch's and ``reduce`` (set by the trainer) sums a
    window's stats over the ranks at the roll-up, so the rates and the MFU
    are the mesh's. ``device`` is the card whose published peak is the MFU
    denominator (``None`` or a CPU device: no MFU).
    """

    flops_counter: Optional[FlopsCounter] = None
    world_size: int = 1
    device: Optional[torch.device] = None
    empty_cache_steps: int = 0
    reduce: Optional[Callable[[List[float]], List[float]]] = None
    consumed_tokens: int = 0
    _step_tokens: int = 0
    _step_token_seq: float = 0.0
    _step_extra_flops: float = 0.0
    _t_start: float = field(default_factory=time.perf_counter)

    def add(self, ntokens: int, seq_len: int, extra_flops: float = 0.0) -> None:
        """extra_flops: promised FORWARD flops outside the LM formula (ViT /
        audio towers, DiT) for this batch; backward-scaled with the rest.

        Attention FLOPs are linear in seq_len per token, so accumulating
        ``ntokens * seq_len`` makes the token-weighted mean seq-len EXACT for
        mixed-length accumulation windows (a max would over-credit MFU the
        moment dynamic batching mixes pack lengths)."""
        self._step_tokens += int(ntokens)
        self._step_token_seq += float(ntokens) * float(seq_len)
        self._step_extra_flops += float(extra_flops)

    def step(self) -> Dict[str, float]:
        now = time.perf_counter()
        dt = max(now - self._t_start, 1e-9)
        if self.reduce is not None:
            tokens, token_seq, extra = self.reduce(
                [self._step_tokens, self._step_token_seq, self._step_extra_flops])
            self._step_tokens, self._step_token_seq = int(round(tokens)), token_seq
            self._step_extra_flops = extra
        tokens = self._step_tokens
        self.consumed_tokens += tokens
        metrics: Dict[str, float] = {
            "tokens_per_sec": tokens / dt,
            "tokens_per_sec_per_chip": tokens / dt / max(1, self.world_size),
            "step_time_s": dt,
            "consumed_tokens": float(self.consumed_tokens),
        }
        has_peak = self.device is not None and torch.device(self.device).type == "cuda"
        if has_peak and self.flops_counter is not None and (tokens or self._step_extra_flops):
            eff_seq = self._step_token_seq / tokens if tokens else 0.0
            achieved = self.flops_counter.batch_flops(tokens, eff_seq or tokens)
            achieved += 3.0 * self._step_extra_flops
            peak = get_device_peak_flops(self.device) * max(1, self.world_size)
            metrics["tflops"] = achieved / dt / 1e12
            metrics["mfu"] = 100.0 * achieved / dt / peak
        self._step_tokens = 0
        self._step_token_seq = 0.0
        self._step_extra_flops = 0.0
        self._t_start = time.perf_counter()
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        # include tokens added but not yet folded by step(): with the
        # log-step rollup cadence a mid-window checkpoint must not
        # undercount trained tokens
        return {"consumed_tokens": self.consumed_tokens + self._step_tokens}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.consumed_tokens = int(state.get("consumed_tokens", 0))


def dump_thread_stacks() -> str:
    """Formatted stack of every live Python thread (the first thing anyone
    needs from a hung multi-host run: WHERE each thread is blocked)."""
    import sys
    import threading
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for tid, frame in sys._current_frames().items():
        parts.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


class Watchdog:
    """Stall detector on a daemon thread (promoted from ``bench.py:_watchdog``
    so the trainer supervisor and the bench share one implementation).

    Arms at :meth:`start`; :meth:`pet` resets the deadline (call once per unit
    of expected progress — a train step, a bench phase). If ``timeout_s``
    elapses with no pet, the dog dumps every thread's stack via
    :func:`dump_thread_stacks`, writes a flight-recorder post-mortem
    (``postmortem-<rank>.json`` — the stack dump alone loses the event
    history; the path lands in :attr:`last_postmortem_path`), invokes
    ``on_stall(stack_dump)`` once per stall, and — unless ``exit_code`` is
    None — hard-exits the process
    (``os._exit``; a wedged backend can't be timeout-killed politely, see
    BENCH_NOTES.md). With ``exit_code=None`` the run is left alive: the stall
    may be a bounded hiccup (slow shared fs) the retry layer absorbs, and the
    dump is the observability artifact either way. Re-arms after firing, so a
    long stall produces periodic dumps rather than one.

    Threading contract (lock-discipline audit, docs/static-analysis.md):
    no lock-guarded state, so no ``# guarded-by:`` annotations. Arming and
    petting ride two ``threading.Event`` objects; ``stall_count`` /
    ``last_dump`` / ``last_postmortem_path`` are written only by the
    watchdog thread and read by observers AFTER a stall is signalled
    (bench reads them from ``on_stall``, which the watchdog thread itself
    invokes) — single-writer, causally-ordered reads.
    """

    # the post-mortem write gets its own deadline: when the stall IS a hung
    # filesystem, blocking on the dump would wedge the watchdog thread
    # before on_stall/exit_code ever run
    DUMP_DEADLINE_S = 15.0

    def __init__(self, timeout_s: float, *, on_stall=None, exit_code=None,
                 description: str = ""):
        import threading

        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.exit_code = exit_code
        self.description = description
        self.stall_count = 0
        self.last_dump: str = ""
        self.last_postmortem_path: str = ""
        self._pet_event = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        import threading

        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, name="veomni-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def pet(self) -> None:
        self._pet_event.set()

    def stop(self) -> None:
        self._done.set()
        self._pet_event.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watch(self) -> None:
        import os as _os
        import threading

        while not self._done.is_set():
            self._pet_event.clear()
            if self._pet_event.wait(self.timeout_s):
                continue  # progress (or stop) before the deadline
            if self._done.is_set():
                return
            self.stall_count += 1
            self.last_dump = dump_thread_stacks()
            logger.error(
                "watchdog: no progress in %.3gs%s; thread stacks:\n%s",
                self.timeout_s,
                f" ({self.description})" if self.description else "",
                self.last_dump,
            )
            # the stack dump says WHERE each thread is; the flight recorder
            # says WHAT the run was doing in the seconds before. Dump BEFORE
            # on_stall so the callback (bench's stall JSON) can reference
            # the artifact path — which means THIS stall must be put on the
            # ring here, not by on_stall, or the artifact it triggers is the
            # one dump with no record of it. Never fatal — dump() is
            # exception-proof — and never unbounded: if the stall IS a hung
            # shared fs, the dump's own writes into it would otherwise wedge
            # THIS thread before on_stall/exit_code run, hanging the driver
            # the watchdog exists to unhang. So the file I/O happens in a
            # side thread joined with a deadline.
            try:
                from veomni_tpu_torch.observability.flight_recorder import (
                    dump_postmortem,
                    record,
                )

                record("watchdog.stall", cid=str(self.stall_count),
                       timeout_s=self.timeout_s,
                       where=self.description or "")
                path_box: list = []
                dumper = threading.Thread(
                    target=lambda: path_box.append(dump_postmortem(
                        f"watchdog:{self.description or 'stall'}",
                        extra={"stall_count": self.stall_count,
                               "timeout_s": self.timeout_s},
                    )),
                    name="veomni-watchdog-dump", daemon=True,
                )
                dumper.start()
                dumper.join(timeout=self.DUMP_DEADLINE_S)
                self.last_postmortem_path = (
                    (path_box[0] or "") if path_box else ""
                )
                if dumper.is_alive():
                    logger.error(
                        "watchdog: post-mortem dump still blocked after "
                        "%.3gs (hung filesystem?) — continuing without it",
                        self.DUMP_DEADLINE_S,
                    )
            except Exception as e:
                # e.g. Thread.start() under thread exhaustion — exactly a
                # pathological stall state; say the dump was attempted
                logger.error("watchdog: post-mortem dump not started: %s", e)
            if self.on_stall is not None:
                try:
                    self.on_stall(self.last_dump)
                except Exception:
                    pass
            if self.exit_code is not None:
                _os._exit(self.exit_code)


def host_floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Keep only host-scalar metric values (drop device futures: fetching
    one would block an async loop). Shared by WandbCallback and the serving
    engine's metric surface."""
    return {k: v for k, v in metrics.items() if isinstance(v, (int, float))}


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seeds Python, numpy and torch; returns a generator on ``device``
    seeded with ``seed`` (the model-init stream, the role of the
    reference's root PRNG key)."""
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def host_rss_bytes() -> float:
    """Current resident-set size of this process in bytes.

    Reads ``/proc/self/statm`` (Linux — a LIVE value that falls when memory
    is released) and falls back to ``resource.getrusage`` peak RSS
    elsewhere (kilobytes on Linux, bytes on macOS). The single home for
    this platform-sensitive read: ``live_memory_stats`` and
    ``observability/devmem.py`` both consume it."""
    try:
        import os

        with open("/proc/self/statm") as f:
            pages = float(f.read().split()[1])
        return pages * float(os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        pass
    try:
        import resource
        import sys

        rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        return rss if sys.platform == "darwin" else rss * 1024.0
    except Exception:
        return 0.0


def live_memory_stats() -> Dict[str, float]:
    """Per-card allocated bytes and their peak (``torch.cuda.memory_stats``
    of the caching allocator; nothing when no card is initialized), plus an
    always-available host RSS reading, so the ``mem.*`` gauge family is live
    on CPU runs too."""
    stats = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            if ms:
                stats[f"device{i}_bytes_in_use"] = float(
                    ms.get("allocated_bytes.all.current", 0))
                stats[f"device{i}_peak_bytes_in_use"] = float(
                    ms.get("allocated_bytes.all.peak", 0))
    rss = host_rss_bytes()
    if rss:
        stats["host_rss_bytes"] = rss
    return stats
