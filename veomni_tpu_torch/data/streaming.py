"""Sharded streaming dataset — the energon/WebDataset-equivalent source (copy of
``veomni_tpu/data/streaming.py``, which imports no JAX; the port keeps its
own copy).

Reference capability: ``veomni/data/dataset.py:1397-1533`` registers a
Megatron-Energon streaming source (sharded webdataset, per-rank worker
split, resumable). Pretraining-scale corpora cannot be mapping datasets.

TPU-native design — deterministic index plans instead of worker processes:

* a corpus is a directory (or glob) of **shards** (``.jsonl`` / ``.parquet``
  / webdataset ``.tar``); each shard gets a tiny record index (line offsets /
  row-group bounds / member groups) built lazily and cached;
* per-epoch order is a pure function of ``(seed, epoch)``: a shard
  permutation plus a per-shard record permutation — no shuffle buffer, so the
  resume state is THREE integers (``epoch, shard_pos, rec_pos``), exact and
  O(1) (no replay, no buffer serialization);
* data parallelism assigns shards ``rank::world_size`` over the permuted
  shard list (ranks stride *records* instead when there are fewer shards
  than ranks);
* random access (``__getitem__`` over the epoch-0 linear order) is also
  provided so a streaming source can sit under ``WeightedMultiSourceDataset``
  mixing like any mapping dataset.
"""

from __future__ import annotations

import glob as _glob
import io
import json
import os
import tarfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from veomni_tpu_torch.data.dataset import DATASET_REGISTRY
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.resilience.faults import fault_point
from veomni_tpu_torch.resilience.integrity import ShardRecordError
from veomni_tpu_torch.resilience.retry import RetryPolicy, retry_call
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SHARD_EXTS = (".jsonl", ".parquet", ".tar")


# ---------------------------------------------------------------------------
# shard readers: len + random record access over a lazily-built index
# ---------------------------------------------------------------------------

class _JsonlShard:
    def __init__(self, path: str):
        self.path = path
        self._offsets = []
        off = 0
        with open(path, "rb") as f:  # single pass: index + blank-line filter
            for line in f:
                if line.strip():
                    self._offsets.append(off)
                off += len(line)

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, i: int) -> Dict[str, Any]:
        with open(self.path, "rb") as f:
            f.seek(self._offsets[i])
            raw = f.readline()
        try:
            return json.loads(raw)
        except ValueError as e:
            # bare JSONDecodeError loses WHICH shard/record rotted — the one
            # fact bad-shard triage (and the poison-skip budget) needs
            raise ShardRecordError(self.path, i, e) from e


class _ParquetShard:
    def __init__(self, path: str):
        import pyarrow.parquet as pq

        self.path = path
        pf = pq.ParquetFile(path)  # index only — no handle is retained
        counts = [pf.metadata.row_group(g).num_rows
                  for g in range(pf.num_row_groups)]
        pf.close()
        self._bounds = np.cumsum([0] + counts)
        self._cached_group: Tuple[int, Optional[List[Dict[str, Any]]]] = (-1, None)

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def read(self, i: int) -> Dict[str, Any]:
        import pyarrow.parquet as pq

        g = int(np.searchsorted(self._bounds, i, side="right") - 1)
        if self._cached_group[0] != g:
            try:
                with pq.ParquetFile(self.path) as pf:
                    self._cached_group = (g, pf.read_row_group(g).to_pylist())
            except OSError:
                raise  # transient I/O: stays retryable, not a poison record
            except Exception as e:  # ArrowInvalid etc.: rotten row group
                raise ShardRecordError(
                    self.path, i, e, detail=f"row group {g}"
                ) from e
        return self._cached_group[1][i - int(self._bounds[g])]


class _TarShard:
    """WebDataset shard: members grouped by basename-before-first-dot into
    one sample per key; extensions decode by convention (json/txt/cls/npy;
    anything else stays raw bytes for the transform to handle)."""

    def __init__(self, path: str):
        self.path = path
        self._groups: List[List[Tuple[str, int, int]]] = []  # [(ext, off, size)]
        groups: Dict[str, List[Tuple[str, int, int]]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for m in tf:
                if not m.isfile():
                    continue
                base = os.path.basename(m.name)
                if "." not in base:
                    continue
                key, ext = base.split(".", 1)
                key = os.path.join(os.path.dirname(m.name), key)
                if key not in groups:
                    groups[key] = []
                    order.append(key)
                groups[key].append((ext.lower(), m.offset_data, m.size))
        self._groups = [groups[k] for k in order]

    def __len__(self) -> int:
        return len(self._groups)

    @staticmethod
    def _decode(ext: str, raw: bytes) -> Any:
        if ext in ("json",):
            return json.loads(raw)
        if ext in ("txt", "text"):
            return raw.decode("utf-8")
        if ext in ("cls", "id"):
            return int(raw.decode("utf-8").strip())
        if ext == "npy":
            return np.load(io.BytesIO(raw), allow_pickle=False)
        return raw

    def read(self, i: int) -> Dict[str, Any]:
        sample: Dict[str, Any] = {}
        with open(self.path, "rb") as f:
            for ext, off, size in self._groups[i]:
                f.seek(off)
                raw = f.read(size)
                try:
                    sample[ext] = self._decode(ext, raw)
                except OSError:
                    raise  # transient I/O: stays retryable
                except Exception as e:  # json/int/npy parse: rotten member
                    raise ShardRecordError(
                        self.path, i, e, detail=f"member .{ext}"
                    ) from e
        # webdataset convention: a lone .json payload IS the sample row
        if set(sample) == {"json"} and isinstance(sample["json"], dict):
            return sample["json"]
        return sample


def _read_record(reader, rec: int) -> Dict[str, Any]:
    """One fetch attempt (the retried unit; exceptions carry reader.path)."""
    fault_point("data.fetch")
    # corrupt-mode drill point: damages the shard ON DISK before the read,
    # so the decode below fails the way real record rot does
    fault_point("data.record", context={"file": reader.path})
    return reader.read(rec)


def _open_shard(path: str):
    if path.endswith(".jsonl"):
        return _JsonlShard(path)
    if path.endswith(".parquet"):
        return _ParquetShard(path)
    if path.endswith(".tar"):
        return _TarShard(path)
    raise ValueError(f"unsupported shard type: {path}")


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@DATASET_REGISTRY.register("streaming")
class StreamingShardDataset:
    """Deterministic sharded streaming with 3-integer exact resume.

    Poison-record policy: a record that fails decode (``ShardRecordError``,
    with shard + index provenance) or the ``validate`` hook is NOT retried —
    rot is persistent. With ``skip_budget == 0`` (default) it fails the run
    fast; with a budget, up to that many distinct ``(shard, record)`` pairs
    are skipped (sequential iteration drops them; random access substitutes
    the next healthy record so batch shapes stay full), each recorded in
    ``state_dict`` so a resumed run replays the identical skips with
    identical budget accounting — bit-exact trajectories survive the
    save/restore boundary. Budget exhaustion re-raises with the full skip
    history."""

    def __init__(
        self,
        path: str,
        *,
        transform=None,
        seed: int = 0,
        shuffle: bool = True,
        dp_rank: int = 0,
        dp_size: int = 1,
        io_retries: int = 3,
        retry_base_s: float = 0.05,
        skip_budget: int = 0,
        validate: Optional[Callable[[Dict[str, Any]], Any]] = None,
        **_,
    ):
        # streaming corpora live on shared/remote filesystems where reads
        # fail transiently; shard opens + record fetches retry with
        # deterministic backoff (and carry the data.fetch fault point)
        self._retry_policy = RetryPolicy(retries=io_retries, base_delay_s=retry_base_s)
        self.skip_budget = max(0, int(skip_budget))
        self.validate = validate
        # skipped (shard key, record) pairs IN SKIP ORDER — rank-local resume
        # state; keys are corpus-root-relative paths, which keep the state
        # relocatable with the corpus while staying distinct across
        # same-named shards in different directories (a glob can span many)
        self._skipped: List[Tuple[str, int]] = []
        self._skipped_set: set = set()
        if os.path.isdir(path):
            shards = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(_SHARD_EXTS)
            )
            self._skip_root = path
        else:
            shards = sorted(_glob.glob(path))
            self._skip_root = (
                os.path.commonpath([os.path.dirname(s) for s in shards])
                if shards else ""
            )
        if not shards:
            raise FileNotFoundError(f"no shards under {path!r}")
        self.shards = shards
        self.transform = transform
        self.seed = seed
        self.shuffle = shuffle
        self.dp_rank = dp_rank
        self.dp_size = max(dp_size, 1)
        # records stride over ranks instead when shards can't
        self._stride_records = len(shards) < self.dp_size
        self._lens: Dict[str, int] = {}
        # readers (with their record indexes) cache per path — re-opening a
        # shard each epoch / on mixing-driven shard switches must not rebuild
        # the index (readers hold offsets/member tables, not file handles)
        self._readers: Dict[str, Any] = {}
        self._epoch = 0
        self._shard_pos = 0
        self._rec_pos = 0
        # globally-keyed within-epoch progress: {corpus-relative shard key ->
        # records consumed this epoch, as a PREFIX of the shard's
        # (seed, epoch, sid)-permuted record order}. The permutation is a
        # pure global function and (with shards >= ranks) each shard is
        # consumed by exactly one rank, so this map — unlike the rank-local
        # (shard_pos, rec_pos) cursor — is world-size-transferable: an
        # elastic N->M resume unions the ranks' maps and every new rank
        # skips the consumed prefix of whatever shards its own assignment
        # holds (resilience/elastic.py).
        self._consumed: Dict[str, int] = {}

    # -- index helpers ------------------------------------------------------
    def _shard_key(self, shard: str) -> str:
        """Corpus-root-relative shard key (same keying as the poison-skip
        history: relocatable with the corpus, distinct across same-named
        shards in different directories)."""
        return os.path.relpath(shard, self._skip_root)

    def _reader(self, shard: str):
        r = self._readers.get(shard)
        if r is None:
            r = self._readers[shard] = retry_call(
                _open_shard, shard, policy=self._retry_policy,
                description=f"open shard {os.path.basename(shard)}",
            )
            self._lens[shard] = len(r)
        return r

    def _fetch(self, reader, rec: int) -> Dict[str, Any]:
        """One record fetch: fault-injectable, retried, validated. No
        per-call closure or eager description string — this is the innermost
        loader loop, and retry_call's qualname fallback only materializes on
        failure. Decode failures (``ShardRecordError``) bypass the retry
        classification (rot is persistent) and surface to the poison-budget
        accounting in the callers."""
        row = retry_call(
            _read_record, reader, rec, policy=self._retry_policy,
        )
        if self.validate is not None:
            try:
                ok = self.validate(row)
            except Exception as e:
                raise ShardRecordError(
                    reader.path, rec, e, detail="validation hook"
                ) from e
            if ok is False:
                raise ShardRecordError(
                    reader.path, rec,
                    ValueError("validation hook rejected record"),
                    detail="validation hook",
                )
        return row

    def _note_poison(self, err: ShardRecordError) -> None:
        """Budget accounting for one poison record; raises when exhausted.
        Re-encounters of an already-recorded pair — post-resume replay, or
        the dataloader's ``__len__`` probe touching the same record training
        later reads — consume NO budget, so replay accounting is exact."""
        key = (self._shard_key(err.shard), int(err.record))
        if key in self._skipped_set:
            logger.warning(
                "re-skipping known poison record %s[%d] (replay)",
                err.shard, err.record,
            )
            return
        if len(self._skipped) >= self.skip_budget:
            raise ShardRecordError(
                err.shard, err.record, err.cause,
                detail=(
                    f"poison-record skip budget exhausted "
                    f"(data_skip_budget={self.skip_budget}, already skipped "
                    f"{self._skipped})"
                ),
            ) from err
        self._skipped.append(key)
        self._skipped_set.add(key)
        get_registry().counter("integrity.data_skipped").inc()
        logger.warning(
            "skipping poison record %s[%d] (%d/%d budget used): %s",
            err.shard, err.record, len(self._skipped), self.skip_budget, err,
        )

    def _shard_len(self, shard: str) -> int:
        if shard not in self._lens:
            self._reader(shard)
        return self._lens[shard]

    def _my_shards(self, epoch: int) -> List[str]:
        order = np.arange(len(self.shards))
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        if self._stride_records:
            return [self.shards[i] for i in order]
        return [self.shards[i] for i in order[self.dp_rank :: self.dp_size]]

    def _rec_order(self, shard: str, epoch: int) -> np.ndarray:
        n = self._shard_len(shard)
        idx = np.arange(n)
        if self.shuffle:
            sid = self.shards.index(shard)
            idx = np.random.default_rng((self.seed, epoch, sid)).permutation(idx)
        if self._stride_records:
            idx = idx[self.dp_rank :: self.dp_size]
        return idx

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """One epoch from the saved cursor (the stateful loader re-iterates
        for the next epoch; ``state_dict`` between yields is exact)."""
        my = self._my_shards(self._epoch)
        while self._shard_pos < len(my):
            shard = my[self._shard_pos]
            key = self._shard_key(shard)
            order = self._rec_order(shard, self._epoch)
            # an elastic restore sets shard_pos/rec_pos to 0 and hands every
            # rank the merged consumed map: skip this shard's already-
            # consumed prefix (same-rank resumes: consumed[key] == rec_pos,
            # so the max is a no-op; legacy states have no map at all)
            self._rec_pos = max(
                self._rec_pos, min(self._consumed.get(key, 0), len(order))
            )
            # _rec_order already opened the shard (the permutation needs its
            # length), so this is a cache hit even for fully-consumed shards
            reader = self._reader(shard)
            while self._rec_pos < len(order):
                try:
                    row = self._fetch(reader, int(order[self._rec_pos]))
                except ShardRecordError as e:
                    self._note_poison(e)  # raises once the budget is spent
                    self._rec_pos += 1
                    self._consumed[key] = self._rec_pos
                    continue
                self._rec_pos += 1
                self._consumed[key] = self._rec_pos
                yield self.transform(row) if self.transform else row
            self._rec_pos = 0
            self._shard_pos += 1
        self._shard_pos = 0
        self._epoch += 1
        self._consumed = {}  # per-epoch progress; the new epoch starts clean

    def state_dict(self) -> Dict[str, Any]:
        return {
            "epoch": self._epoch,
            "shard_pos": self._shard_pos,
            "rec_pos": self._rec_pos,
            # globally-keyed progress (copied: the prefetch thread snapshots
            # this between batches while iteration keeps mutating the map)
            "consumed": dict(self._consumed),
            # list-of-lists (JSON-stable) in skip order: restoring makes the
            # resumed run replay the identical skips with identical budget
            "skipped": [[s, r] for s, r in self._skipped],
            # elastic-merge metadata (resilience/elastic.py): which rank of
            # which world wrote this, and whether records (not shards) were
            # strided over ranks — the one assignment that is NOT
            # prefix-mergeable across a world resize
            "dp_rank": self.dp_rank,
            "dp_size": self.dp_size,
            "stride_records": bool(self._stride_records),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state.get("elastic") and state.get("consumed")
                and self._stride_records):
            # an elastically-merged mid-epoch cursor arriving at a dataset
            # that strides RECORDS over ranks (fewer shards than ranks):
            # this rank's _rec_order is a strided subsequence, so clamping
            # the global consumed-prefix counts against it would silently
            # repeat records on some ranks and skip them on others — the
            # exact corruption elastic restore exists to prevent. The saved
            # side of this check lives in elastic._merge_streaming; only
            # the dataset knows the TARGET regime.
            from veomni_tpu_torch.resilience.elastic import ElasticRestoreError

            raise ElasticRestoreError(
                f"elastic streaming resume onto {self.dp_size} ranks with "
                f"only {len(self.shards)} shard(s): the record-strided "
                f"assignment is not prefix-addressable, so the merged "
                f"mid-epoch cursor cannot be applied. Resume on at most "
                f"{len(self.shards)} ranks, resume from an epoch-boundary "
                f"checkpoint, or re-shard the corpus into >= world_size "
                f"shards."
            )
        self._epoch = int(state.get("epoch", 0))
        self._shard_pos = int(state.get("shard_pos", 0))
        self._rec_pos = int(state.get("rec_pos", 0))
        consumed = {
            str(k): int(v) for k, v in (state.get("consumed") or {}).items()
        }
        if consumed:
            # keep only THIS rank's assignment: an elastically-merged map
            # carries every rank's entries, but foreign ones are never
            # consulted here — re-serializing them into later checkpoints
            # would go stale as their owners advance, triggering false
            # consumed-count-conflict alarms on the NEXT resize (and sidecar
            # size would grow with the corpus, not this rank's share)
            mine = {
                self._shard_key(s) for s in self._my_shards(self._epoch)
            }
            consumed = {k: v for k, v in consumed.items() if k in mine}
        self._consumed = consumed
        self._skipped = [(str(s), int(r)) for s, r in state.get("skipped", [])]
        self._skipped_set = set(self._skipped)

    # -- random access (weighted mixing) ------------------------------------
    def _bounds(self):
        """Cumulative record bounds over shards; built ONCE on the first
        random access (random access inherently needs every shard's length —
        the sequential __iter__ path stays lazy)."""
        if not hasattr(self, "_bounds_cache"):
            self._bounds_cache = np.cumsum(
                [0] + [self._shard_len(s) for s in self.shards]
            )
        return self._bounds_cache

    def __len__(self) -> int:
        return int(self._bounds()[-1])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """Linear (epoch-0, unshuffled, all-rank) order — lets a streaming
        source plug into WeightedMultiSourceDataset's cursor mixing.

        A poison record here cannot be dropped (the caller is filling a
        fixed batch shape), so within the skip budget it deterministically
        substitutes the next healthy record in linear order (wrapping) —
        the same substitution on every encounter, before and after resume."""
        b = self._bounds()
        total = int(b[-1])
        if idx < 0 or idx >= total:
            raise IndexError(idx)
        probe = idx
        for _ in range(total):  # at most one full lap; budget raises earlier
            si = int(np.searchsorted(b, probe, side="right") - 1)
            try:
                row = self._fetch(self._reader(self.shards[si]), probe - int(b[si]))
            except ShardRecordError as e:
                self._note_poison(e)  # raises once the budget is spent
                probe = (probe + 1) % total
                continue
            return self.transform(row) if self.transform else row
        raise ShardRecordError(  # unreachable with a finite budget
            self.shards[0], idx, RuntimeError("every record poisoned"),
        )
