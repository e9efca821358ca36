"""Generic string-keyed registry (reference: ``veomni/utils/registry.py``).

Used for datasets, dataloaders, transforms, model families, kernels, etc.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Any] = {}

    def register(self, key: str, obj: Optional[Any] = None, *, override: bool = False):
        """Register ``obj`` under ``key``; usable as a decorator when obj is None."""

        def _do(o):
            if key in self._store and not override:
                raise KeyError(f"{self.name}: duplicate key {key!r}")
            self._store[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def get(self, key: str) -> Any:
        if key not in self._store:
            raise KeyError(
                f"{self.name}: unknown key {key!r}; available: {sorted(self._store)}"
            )
        return self._store[key]

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __iter__(self) -> Iterator[str]:
        return iter(self._store)

    def keys(self):
        return self._store.keys()

    def items(self):
        return self._store.items()
