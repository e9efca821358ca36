"""Bounded retry with deterministic exponential backoff.

Shared-filesystem checkpoint I/O and streaming/HF data fetches fail
transiently at multi-host scale; the policy here is deliberately boring —
``base * 2**attempt`` capped, NO jitter — so a fault-plan test can predict
exactly how many attempts a budget buys and the whole recovery path stays
reproducible. On exhaustion the ORIGINAL exception is re-raised (callers'
except-clauses keep working; the retry layer never launders error types).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Tuple, Type

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# OSError covers shared-fs hiccups, TensorStore I/O wrappers that subclass
# it, network timeouts (socket.timeout = TimeoutError = an OSError), and the
# fault layer's InjectedFault. ValueError/TypeError etc. are NOT retried:
# a schema mismatch won't fix itself and retrying masks the real bug.
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError, IOError)


@dataclass(frozen=True)
class RetryPolicy:
    """``retries`` = extra attempts after the first (total = retries + 1)."""

    retries: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)

    def schedule(self, attempts: int) -> Tuple[float, ...]:
        """The exact backoff sequence ``attempts`` retries will sleep —
        ``(delay(0), ..., delay(attempts-1))``. Deterministic by design
        (no jitter), so a planner that spaces retries itself — the
        serving router's replica-respawn scheduler — and a fault-plan
        test can both pin the whole timeline ahead of time."""
        return tuple(self.delay(i) for i in range(max(0, attempts)))


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    policy: RetryPolicy = RetryPolicy(),
    description: str = "",
    sleep: Callable[[float], None] = time.sleep,
    **kwargs: Any,
) -> Any:
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Each RETRIED failure logs at warning with the remaining budget and bumps
    the ``retry.attempts`` counter (it counts retries actually burned, not
    total failed attempts: the exhausting failure is not retried, so
    ``retries=2`` records 2, not 3); exhaustion bumps ``retry.exhausted``,
    logs at error WITH the attempt count and total backoff burned (the
    original exception re-raises unchanged, so without this line there would
    be no evidence retries ever happened), and re-raises.
    """
    what = None
    attempt = 0
    total_backoff = 0.0
    while True:
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            # failure path only: the registry/recorder imports
            # (observability-layer; retry is leaf) and the qualname fallback
            # stay off the success path — this wraps the innermost
            # record-fetch loop
            from veomni_tpu_torch.observability.flight_recorder import record
            from veomni_tpu_torch.observability.metrics import get_registry

            if what is None:
                what = description or getattr(fn, "__qualname__", repr(fn))
            record("retry.attempt", cid=what, attempt=attempt + 1,
                   error=f"{type(e).__name__}: {e}"[:200])
            if attempt >= policy.retries:
                get_registry().counter("retry.exhausted").inc()
                logger.error(
                    "%s: retry budget exhausted after %d attempt(s) "
                    "(%.3gs total backoff): %s",
                    what, attempt + 1, total_backoff, e,
                )
                raise
            delay = policy.delay(attempt)
            attempt += 1
            total_backoff += delay
            get_registry().counter("retry.attempts").inc()
            logger.warning(
                "%s failed (attempt %d/%d): %s; retrying in %.3gs",
                what, attempt, policy.retries + 1, e, delay,
            )
            sleep(delay)
