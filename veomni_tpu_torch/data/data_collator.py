"""Sample packing into fixed-shape micro-batches.

Copy of ``TextPackingCollator`` and ``stack_micro_batches`` from
``veomni_tpu/data/data_collator.py`` (``:78``), which are framework-free
numpy; the port keeps its own copy so it runs where the JAX package is
absent. Greedy first-fit packing fills ``[micro_batch_size, seq_len]`` rows
and pads the tail: padding tokens carry segment id 0 and label -100, real
segments are numbered from 1 per row, and position ids restart per segment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

IGNORE_INDEX = -100


def _json_safe(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    return v


def serialize_sample(sample: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe copy of a buffered sample preserving every key."""
    return {k: _json_safe(v) for k, v in sample.items()}


class TextPackingCollator:
    """Greedy first-fit packing of tokenized samples into [B, S] buffers."""

    def __init__(
        self,
        seq_len: int,
        micro_batch_size: int = 1,
        *,
        sp_size: int = 1,
        drop_oversized: bool = True,
        with_channels: bool = False,
    ):
        self.with_channels = with_channels
        if seq_len % max(sp_size, 1):
            raise ValueError(f"seq_len {seq_len} must be divisible by sp_size {sp_size}")
        self.seq_len = seq_len
        self.micro_batch_size = micro_batch_size
        self.drop_oversized = drop_oversized
        # samples that didn't fit this call carry over to the next micro-batch
        self._pending: List[Dict[str, Any]] = []
        self.dropped_oversized = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "pending": [serialize_sample(s) for s in self._pending],
            "dropped_oversized": self.dropped_oversized,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._pending = list(state.get("pending", []))
        self.dropped_oversized = int(state.get("dropped_oversized", 0))

    def carryover_len(self) -> int:
        return len(self._pending)

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        """samples: dicts with 'input_ids' (list[int]) and optional 'labels'
        (same length; -100 where loss is masked, e.g. prompt tokens)."""
        b, s = self.micro_batch_size, self.seq_len
        input_ids = np.zeros((b, s), np.int32)
        labels = np.full((b, s), IGNORE_INDEX, np.int32)
        position_ids = np.zeros((b, s), np.int32)
        segment_ids = np.zeros((b, s), np.int32)
        channel_ids = np.full((b, s), -1, np.int32) if self.with_channels else None
        fill = [0] * b
        nseg = [0] * b

        queue = self._pending + list(samples)
        self._pending = []
        for sample in queue:
            ids = np.asarray(sample["input_ids"], np.int32)
            lab = np.asarray(sample.get("labels", sample["input_ids"]), np.int32)
            # next-token shift at the sample level: predict ids[t+1] at t
            shifted = np.concatenate([lab[1:], [IGNORE_INDEX]]).astype(np.int32)
            n = len(ids)
            if n > s:
                if self.drop_oversized:
                    self.dropped_oversized += 1
                    continue
                ids, shifted = ids[:s], shifted[:s]
                n = s
            row = next((i for i in range(b) if fill[i] + n <= s), None)
            if row is None:
                self._pending.append(sample)  # re-offered next micro-batch
                continue
            lo, hi = fill[row], fill[row] + n
            input_ids[row, lo:hi] = ids
            labels[row, lo:hi] = shifted
            labels[row, hi - 1] = IGNORE_INDEX  # never predict across boundary
            position_ids[row, lo:hi] = np.arange(n)
            nseg[row] += 1
            segment_ids[row, lo:hi] = nseg[row]
            if channel_ids is not None:
                channel_ids[row, lo:hi] = int(sample.get("channel", -1))
            fill[row] = hi

        out = {
            "input_ids": input_ids,
            "labels": labels,
            "position_ids": position_ids,
            "segment_ids": segment_ids,
        }
        if channel_ids is not None:
            out["channel_ids"] = channel_ids
        return out


def stack_micro_batches(micro_batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Group A micro-batches into the [A, B, S] grad-accum layout."""
    keys = micro_batches[0].keys()
    return {k: np.stack([mb[k] for mb in micro_batches]) for k in keys}
