"""Speculative-decoding draft strategies (host side, registry dispatched).

Copy of ``veomni_tpu/serving/spec_decode.py`` on the port's kernel
registry.

Draft-then-verify decoding replaces the engine's one-token decode tick with
a cheap host-side **draft** of up to k continuation tokens per slot plus ONE
batched **verify** step (``models/decode.py::paged_verify_step``)
that scores all k+1 positions at once and accepts the longest prefix
matching target-model sampling. The drafting strategy is the pluggable
half: it runs on the host between device steps (microseconds against a
decode step's milliseconds), so it is dispatched through the kernel
registry like ``ulysses`` and ``paged_attention`` — an ops-config pin or
``EngineConfig.spec_draft`` selects the impl, and a future model-based
drafter (small draft model over the same bucketed step machinery) slots in
without touching the engine.

Shipped impls:

- ``ngram`` — self-speculative **prompt lookup** (vLLM's
  ngram-prompt-lookup / HF's prompt_lookup_decoding): find the most recent
  earlier occurrence of the longest matching tail n-gram in the sequence's
  own prompt + generated ids and propose the tokens that followed it.
  Needs no second model and wins hardest on the shared-prefix /
  re-summarization traffic the prefix cache optimizes: continuations
  that restate the prompt accept nearly every draft.
- ``off`` — proposes nothing: every tick degrades to the pure decode step.

A draft is only ever a *proposal*: the verify step accepts a token iff it
equals what the target model would have emitted at that position (greedy
argmax or the seeded categorical draw), so a bad drafter can cost
throughput but can never change a single output token.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY

#: tail n-gram sizes the prompt-lookup drafter tries, longest first — a
#: longer match is more specific, so its continuation is accepted more often
NGRAM_MAX = 3

#: lookback cap for the prompt-lookup scan: drafting runs on the host
#: BETWEEN device steps for every slot every tick, so its cost must not
#: grow with sequence length — matches beyond this window are stale enough
#: that the acceptance loss is noise next to the per-tick latency win
NGRAM_WINDOW = 4096


@KERNEL_REGISTRY.register("spec_draft", "off", priority=1)
def draft_off(context: Sequence[int], k: int) -> List[int]:
    """The trivial drafter: never proposes. Auto-resolution picks this
    (highest priority) so speculation is opt-in by NAME, never by accident
    of registration order."""
    return []


@KERNEL_REGISTRY.register("spec_draft", "ngram")
def draft_ngram(context: Sequence[int], k: int) -> List[int]:
    """Prompt-lookup drafting over the sequence's own token history.

    ``context`` is the committed stream (prompt + every generated token,
    the pending last token included — proposals continue AFTER it); ``k``
    caps the proposal length. Tries tail n-grams of size ``NGRAM_MAX``
    down to 1 and, for the longest size that recurs earlier in the
    context, proposes the tokens that followed its MOST RECENT earlier
    occurrence. Returns [] when nothing matches (or the match sits at the
    very end with nothing after it) — the engine degrades that slot to
    k=0, i.e. a pure decode step, instead of wasting verify width."""
    if k <= 0 or len(context) < 2:
        return []
    # vectorized over a bounded lookback window: per-tick cost is O(window)
    # of numpy compares, never O(sequence) of Python-level slicing
    arr = np.asarray(context[-NGRAM_WINDOW:], dtype=np.int64)
    n = arr.shape[0]
    for m in range(min(NGRAM_MAX, n - 1), 0, -1):
        tail = arr[n - m:]
        # candidate start positions of the tail n-gram, excluding its own
        # occurrence at n - m
        hits = arr[: n - m] == tail[0]
        for j in range(1, m):
            # candidates may overlap the tail's own span (repetition runs),
            # so each offset-j compare covers the full candidate range
            hits &= arr[j: j + n - m] == tail[j]
        cand = np.flatnonzero(hits)
        if cand.size == 0:
            continue
        i = int(cand[-1])  # most recent earlier occurrence
        # i <= n - m - 1, so at least one token always follows the match
        return [int(t) for t in arr[i + m: i + m + k]]
    return []


def resolve_draft_fn(name: str):
    """Look up a drafting impl by name (the ``EngineConfig.spec_draft``
    surface), honoring a registry pin when one is set — same precedence as
    the ``ulysses`` dispatcher: ops-config pin > engine knob."""
    pin = KERNEL_REGISTRY.pinned("spec_draft")
    name = pin or name
    impls = KERNEL_REGISTRY.impls("spec_draft")
    if name not in impls:
        raise ValueError(
            f"unknown spec_draft impl {name!r}; registered: {sorted(impls)}"
        )
    return impls[name].fn
