"""Datasets: registry + mapping/iterable/interleave/weighted sources.

Reference: ``veomni/data/dataset.py:50,1254-1533`` (DATASET_REGISTRY with
mapping / iterable / interleave / energon / weighted-multisource). Pure
Python/numpy here (no torch/torchdata): sources yield dicts of tokenized
samples; resumability is explicit ``state_dict``/``load_state_dict`` on every
dataset (the reference leans on torchdata StatefulDataLoader for this).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from veomni_tpu_torch.utils.logging import get_logger
from veomni_tpu_torch.utils.registry import Registry

logger = get_logger(__name__)

DATASET_REGISTRY = Registry("datasets")


def _load_rows(path: str) -> List[Dict[str, Any]]:
    """Load jsonl / json / parquet rows from a file or directory."""
    paths: List[str] = []
    if os.path.isdir(path):
        for f in sorted(os.listdir(path)):
            if f.endswith((".jsonl", ".json", ".parquet")):
                paths.append(os.path.join(path, f))
    else:
        paths = [path]
    rows: List[Dict[str, Any]] = []
    for p in paths:
        if p.endswith(".parquet"):
            import pyarrow.parquet as pq  # available via transformers deps

            rows.extend(pq.read_table(p).to_pylist())
        elif p.endswith(".jsonl"):
            with open(p) as f:
                rows.extend(json.loads(line) for line in f if line.strip())
        else:
            with open(p) as f:
                data = json.load(f)
                rows.extend(data if isinstance(data, list) else [data])
    return rows


@DATASET_REGISTRY.register("mapping")
class MappingDataset:
    """In-memory random-access dataset with optional transform."""

    def __init__(self, path: Optional[str] = None, *, rows: Optional[List[Dict]] = None,
                 transform=None, **_):
        self.rows = rows if rows is not None else _load_rows(path)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.rows[idx]
        return self.transform(row) if self.transform else row


@DATASET_REGISTRY.register("iterable")
class IterableDataset:
    """Streaming dataset over large files with checkpointable cursor."""

    def __init__(self, path: str, *, transform=None, **_):
        self.path = path
        self.transform = transform
        self._cursor = 0

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rows = _load_rows(self.path)
        for i in range(self._cursor, len(rows)):
            self._cursor = i + 1
            row = rows[i]
            yield self.transform(row) if self.transform else row

    def state_dict(self):
        return {"cursor": self._cursor}

    def load_state_dict(self, state):
        self._cursor = int(state.get("cursor", 0))


@DATASET_REGISTRY.register("interleave")
class InterleaveDataset:
    """Interleaved view over several mapping datasets (exact bijection:
    every underlying sample appears exactly once per epoch)."""

    def __init__(self, datasets: Sequence[MappingDataset], **_):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]
        self._offsets = np.cumsum([0] + self._lens)
        # deterministic interleaved order across sources
        order = []
        for d, n in enumerate(self._lens):
            order.extend((self._offsets[d] + i, i * len(self.datasets) + d) for i in range(n))
        order.sort(key=lambda t: t[1])
        self._order = [t[0] for t in order]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx):
        flat = self._order[idx]
        d = int(np.searchsorted(self._offsets, flat, side="right") - 1)
        return self.datasets[d][flat - self._offsets[d]]


@DATASET_REGISTRY.register("weighted")
class WeightedMultiSourceDataset:
    """Weighted sampling across sources with resumable per-source state
    (reference WeightedMultiSourceDataset, ``data/dataset.py:358``)."""

    def __init__(self, datasets: Sequence[Any], weights: Sequence[float], seed: int = 0, **_):
        assert len(datasets) == len(weights)
        self.datasets = list(datasets)
        self.weights = np.asarray(weights, np.float64) / np.sum(weights)
        self._rng = np.random.default_rng(seed)
        self._cursors = [0] * len(datasets)
        self._seed = seed
        self._draws = 0

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            src = int(self._rng.choice(len(self.datasets), p=self.weights))
            ds = self.datasets[src]
            item = ds[self._cursors[src] % len(ds)]
            self._cursors[src] += 1
            self._draws += 1
            yield item

    def state_dict(self):
        return {
            "cursors": list(self._cursors),
            "draws": self._draws,
            "seed": self._seed,
            # O(1) exact resume: serialize the generator state directly
            "rng_state": json.loads(json.dumps(self._rng.bit_generator.state)),
        }

    def load_state_dict(self, state):
        self._cursors = list(state["cursors"])
        self._seed = state.get("seed", self._seed)
        self._rng = np.random.default_rng(self._seed)
        if "rng_state" in state:
            self._rng.bit_generator.state = state["rng_state"]
        self._draws = int(state.get("draws", 0))


def build_dataset(dataset_type: str = "mapping", **kwargs):
    """Reference ``build_dataset`` (data/dataset.py:50)."""
    if dataset_type == "streaming":
        import veomni_tpu_torch.data.streaming  # noqa: F401  (registers itself)
    return DATASET_REGISTRY.get(dataset_type)(**kwargs)
