"""Versioned weight payloads for live publication into a serving fleet.

Port of ``veomni_tpu/serving/weights.py`` (``WeightRecord``,
``WeightStore``, ``load_published_params``, ``:54-150``) over the port's
``resilience/integrity.py``, plus the checkpoint loader the reference keeps
in ``scripts/serve.py:112-132`` (an Orbax restore there):
``load_checkpoint_params`` reads the ``global_step_N/train_state/model.pt``
that ``checkpoint/checkpointer.py`` writes.

* ``WeightStore``: an append-only map of version tag -> payload, each with a
  monotonic ``seq``. Tags are immutable once published: a replica that
  swapped to "v1" must never disagree with one that swaps to "v1" later.
* ``WeightRecord``: one (version, seq, payload). The payload is the model's
  unquantized ``{name: tensor}`` state on the host; each engine casts (and
  under ``weight_quant="int8"`` quantizes) its own device copy at spawn and
  at swap, so the store holds no device memory.
* ``load_published_params``: the checkpoint-to-publish gate. An
  uncommitted generation, or one whose manifest fails verification, is
  refused with ``CheckpointCorruptError`` before the loader reads a byte.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

from veomni_tpu_torch.resilience.integrity import (
    CheckpointCorruptError,
    is_committed_dir,
    verify_manifest,
)

__all__ = ["WeightRecord", "WeightStore", "host_state", "load_checkpoint_params",
           "load_published_params"]


@dataclass(frozen=True)
class WeightRecord:
    """One published weight payload: opaque tag, monotonic seq, payload."""

    version: str
    seq: int
    params: Any


class WeightStore:
    """Append-only, version-tagged weight payloads with monotonic seqs. Not
    thread-safe by itself: the router publishes and reads on its own pump
    thread; pump workers never touch the store."""

    def __init__(self, params: Any, version: str = "v0"):
        self._by_version: Dict[str, WeightRecord] = {}
        self._order: List[str] = []
        self.put(version, params)

    def put(self, version: str, params: Any) -> WeightRecord:
        """Publish ``params`` under ``version``; a duplicate tag is refused
        (ValueError): two replicas on the same tag hold the same weights."""
        version = str(version)
        if not version:
            raise ValueError("weights version tag must be non-empty")
        if version in self._by_version:
            raise ValueError(f"weights version {version!r} already published; version "
                             f"tags are immutable (pick a new tag)")
        rec = WeightRecord(version=version, seq=len(self._order), params=params)
        self._by_version[version] = rec
        self._order.append(version)
        return rec

    @property
    def latest(self) -> WeightRecord:
        return self._by_version[self._order[-1]]

    def get(self, version: str) -> WeightRecord:
        return self._by_version[str(version)]

    def seq(self, version: str) -> int:
        """Monotonic sequence number of ``version`` (-1 if unknown)."""
        rec = self._by_version.get(str(version))
        return rec.seq if rec is not None else -1

    def versions(self) -> List[str]:
        return list(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, version: object) -> bool:
        return str(version) in self._by_version


def host_state(model) -> Dict[str, torch.Tensor]:
    """A publishable payload: ``model``'s parameters (a ``Transformer``, or
    already a ``{name: tensor}`` state) as host tensors, copied from a card,
    shared when already on the host."""
    state = model if isinstance(model, dict) else dict(model.named_parameters())
    return {name: t.detach().cpu() for name, t in state.items()}


def load_checkpoint_params(step_dir: str) -> Dict[str, torch.Tensor]:
    """The model's state of a port checkpoint generation
    (``<step_dir>/train_state/model.pt``, ``checkpoint/checkpointer.py``),
    on the host. The optimizer's file is not read."""
    path = os.path.join(os.fspath(step_dir), "train_state", "model.pt")
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=True)


def load_published_params(step_dir: str, loader: Callable[[str], Any] = load_checkpoint_params,
                          *, verify_mode: str = "size") -> Any:
    """Integrity-gate a checkpoint generation, then load it with ``loader``.

    An uncommitted directory (no ``train_state/``) and a manifest that fails
    ``verify_manifest(mode=verify_mode)`` raise ``CheckpointCorruptError``
    before ``loader`` runs; a generation without a manifest is unverifiable
    and loads. ``verify_mode="off"`` skips the manifest but still refuses
    an uncommitted directory."""
    step_dir = os.fspath(step_dir)
    if not is_committed_dir(step_dir):
        raise CheckpointCorruptError(
            f"refusing to publish from {step_dir!r}: not a committed checkpoint generation "
            f"(no train_state/ subtree)")
    if verify_mode != "off":
        report = verify_manifest(step_dir, mode=verify_mode)
        if report is not None and not report.passed:
            raise CheckpointCorruptError(
                f"refusing to publish from {step_dir!r}: integrity verification failed — "
                f"{report.summary()}")
    return loader(step_dir)
