"""Token-budget dynamic batching (copy of ``veomni_tpu/data/dynamic_batching.py``,
which imports no JAX; the port keeps its own copy).

Reference: ``veomni/data/dynamic_batching.py:29-404`` — DynBszBuffer greedy
knapsack over a sample buffer with effective-vs-max token caps and a warmup
ramp; checkpointable. TPU translation: shapes stay static (the packing
collator always emits [B, S]); dynamic batching decides *which samples* feed
each micro-batch so token waste is minimized, instead of varying tensor
shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class DynBszBuffer:
    """Greedy first-fit-decreasing knapsack over a lookahead buffer."""

    def __init__(self, token_budget: int, buffer_size: int = 200):
        self.token_budget = token_budget       # current (warmup-scaled) budget
        self.max_token_budget = token_budget   # steady-state budget
        self.buffer_size = buffer_size
        self.dropped_oversized = 0
        self._buf: List[Dict[str, Any]] = []

    def put(self, sample: Dict[str, Any]) -> None:
        # samples over the steady-state budget could never be selected and
        # would pin buffer slots forever (cf. TextPackingCollator.drop_oversized)
        if len(sample["input_ids"]) > self.max_token_budget:
            self.dropped_oversized += 1
            return
        self._buf.append(sample)

    @property
    def full(self) -> bool:
        return len(self._buf) >= self.buffer_size

    def __len__(self) -> int:
        return len(self._buf)

    def pop_batch(self) -> List[Dict[str, Any]]:
        """Select samples totaling <= token_budget, longest-first."""
        order = sorted(range(len(self._buf)),
                       key=lambda i: -len(self._buf[i]["input_ids"]))
        chosen, total = [], 0
        for i in order:
            n = len(self._buf[i]["input_ids"])
            if total + n <= self.token_budget:
                chosen.append(i)
                total += n
        if not chosen and self._buf:
            # warmup-shrunk budget can exclude everything buffered; emit the
            # shortest sample alone rather than stalling the iterator
            chosen = [min(range(len(self._buf)),
                          key=lambda i: len(self._buf[i]["input_ids"]))]
        chosen_set = set(chosen)
        batch = [self._buf[i] for i in chosen]
        self._buf = [s for i, s in enumerate(self._buf) if i not in chosen_set]
        return batch

    def state_dict(self) -> Dict[str, Any]:
        from veomni_tpu_torch.data.data_collator import serialize_sample

        # persist every sample key (channel etc.), mirroring
        # TextPackingCollator.state_dict — dropping fields here misattributes
        # channel loss for buffered samples after resume
        return {"buffer": [serialize_sample(s) for s in self._buf]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._buf = list(state.get("buffer", []))


class DynamicBatchDataloader:
    """Wraps a sample iterator + packing collator with token-budget fills
    (reference DynamicBatchSizeDataLoader, main-process runtime), including
    the warmup ramp (``bsz_warmup_*``: budget scales linearly over the first
    ``warmup_steps`` batches)."""

    def __init__(
        self,
        dataset,
        collate_fn,
        *,
        token_budget: int,
        grad_accum_steps: int = 1,
        buffer_size: int = 200,
        warmup_steps: int = 0,
        warmup_init_ratio: float = 0.25,
        seed: int = 0,
        dp_rank: int = 0,
        dp_size: int = 1,
        infinite: bool = True,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.token_budget = token_budget
        self.grad_accum_steps = grad_accum_steps
        self.warmup_steps = warmup_steps
        self.warmup_init_ratio = warmup_init_ratio
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.infinite = infinite
        self._buffer = DynBszBuffer(token_budget, buffer_size)
        self._epoch = 0
        self._cursor = 0
        self._batches_emitted = 0

    def _budget(self) -> int:
        if self.warmup_steps and self._batches_emitted < self.warmup_steps:
            frac = self.warmup_init_ratio + (1 - self.warmup_init_ratio) * (
                self._batches_emitted / self.warmup_steps
            )
            return max(1, int(self.token_budget * frac))
        return self.token_budget

    def _sample_stream(self) -> Iterator[Dict[str, Any]]:
        while True:
            n = len(self.dataset)
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
            per = n // self.dp_size
            mine = order[self.dp_rank * per: (self.dp_rank + 1) * per]
            while self._cursor < len(mine):
                idx = int(mine[self._cursor])
                self._cursor += 1
                yield self.dataset[idx]
            self._epoch += 1
            self._cursor = 0
            if not self.infinite:
                return

    def __iter__(self):
        from veomni_tpu_torch.data.data_collator import stack_micro_batches

        stream = self._sample_stream()
        while True:
            micro = []
            for _ in range(self.grad_accum_steps):
                self._buffer.token_budget = self._budget()
                try:
                    while not self._buffer.full:
                        self._buffer.put(next(stream))
                except StopIteration:
                    if len(self._buffer) == 0:
                        return
                batch = self._buffer.pop_batch()
                if not batch:
                    return
                micro.append(self.collate_fn(batch))
                self._batches_emitted += 1
            yield stack_micro_batches(micro)

    def __len__(self) -> int:
        """Estimated batches per epoch (probe-averaged sample length)."""
        n = len(self.dataset)
        stride = max(1, n // 100)
        lens = [len(self.dataset[i]["input_ids"]) for i in range(0, n, stride)][:100]
        avg = max(1.0, float(np.mean(lens)))
        per_rank_tokens = (n / self.dp_size) * avg
        return max(1, int(per_rank_tokens / self.token_budget / self.grad_accum_steps))

    def state_dict(self) -> Dict[str, Any]:
        state = {
            "epoch": self._epoch, "cursor": self._cursor, "seed": self.seed,
            "batches_emitted": self._batches_emitted,
            "buffer": self._buffer.state_dict(),
        }
        if hasattr(self.collate_fn, "state_dict"):
            state["collator"] = self.collate_fn.state_dict()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self.seed = int(state.get("seed", self.seed))
        self._batches_emitted = int(state.get("batches_emitted", 0))
        self._buffer.load_state_dict(state.get("buffer", {}))
        if "collator" in state and hasattr(self.collate_fn, "load_state_dict"):
            self.collate_fn.load_state_dict(state["collator"])
