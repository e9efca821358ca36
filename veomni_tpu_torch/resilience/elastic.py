"""Elastic checkpoints: restore across a different mesh shape / world size.

PR 3/5 made survive-and-resume first-class, but the resume always assumed the
*same* topology: the mesh is baked into the sharded state and the data
cursors / skip-budget accounting live in per-process sidecars
(``extra_state_rank{i}.json``), so a preempted v5e-16 run could not fall back
to v5e-8 and a pod could not grow mid-run. This module supplies the three
pieces that make the checkpoint layout universal (veScale's
save-on-N/load-on-M consistency claim; GSPMD's global-view arrays make the
array half a first-class reshard-on-load):

* **topology capture** — :func:`capture_topology` records the source mesh
  (axis names/sizes), world size, device count and torch/CUDA versions; the
  checkpointer writes it into every generation's ``manifest.json`` (even
  with ``ckpt_verify=off``) so old checkpoints are at least diagnosable;
* **compatibility gate** — :func:`classify_restore` yields one verdict
  (``ok`` / ``elastic`` / ``incompatible`` / ``unknown``) shared by the
  checkpointer's restore gate and ``scripts/verify_ckpt.py``. Pure
  data-parallel resizes (``dp_replicate``/``fsdp`` extents, world size) are
  elastic; model-parallel *degree* changes (``tp``/``ep``/``ulysses``/
  ``cp``/``pp``) are refused with an actionable error — they change the
  per-step math/layout contract (head chunking, ring slicing, expert
  capacity), not just where bytes live;
* **cursor merge/split** — :func:`merge_rank_states` folds N saved per-rank
  sidecars into one world-size-agnostic doc, :func:`split_rank_state` derives
  any target rank's state from it. Streaming iterator cursors are keyed
  *globally* (per-shard consumed-prefix counts in the deterministic
  ``(seed, epoch, shard)`` record order — see
  ``data/streaming.py``), so an N→M resume consumes **exactly** the records
  the N-rank run would have, replayed poison skips included. The native
  mapping loader's contiguous-block cursor is only *position*-preserving
  across a resize (exact at epoch boundaries); the split says so loudly.

Deliberately **torch-free at import** (an operator tool classifies
topologies without touching a backend); :func:`capture_topology` imports
torch lazily. Port of ``veomni_tpu/resilience/elastic.py``: only
:func:`capture_topology` changes (it reads ``torch.distributed`` and
``torch.cuda`` instead of jax devices); the gate and the cursor merge/split
are the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOPOLOGY_VERSION = 1

#: mesh axes whose extent may change under an elastic restore: pure data
#: parallelism — the global arrays reshard and the global batch stays the
#: operator's (micro_batch x dp) contract to hold constant.
DATA_AXES = ("dp_replicate", "fsdp")

#: mesh axes whose extent must NOT change: these alter the per-step
#: math/layout contract (Ulysses head chunking, ring CP slicing, per-device
#: expert capacity, TP feature splits, pipeline staging), so a resumed run
#: could not replay the original trajectory even with perfectly resharded
#: arrays.
MODEL_PARALLEL_AXES = ("pp", "ep", "ulysses", "cp", "tp")


class ElasticRestoreError(RuntimeError):
    """A checkpoint cannot be restored onto the current topology.

    Deliberately NOT an ``OSError``: the mismatch is persistent, so the
    retry layer must not burn its budget re-reading the same sidecars — the
    caller's response is to fix the topology (or enable/extend elastic
    restore), not to retry.

    ``config_error=True`` marks the CONFIG-class variants (elastic knob
    off on a resized world, model-parallel degree change): those apply to
    the run as a whole, so the checkpointer's fallback walk aborts instead
    of sliding past newer generations onto a stale pre-resize one —
    silently losing the steps in between would be worse than the error.
    Per-generation damage (torn sidecar sets, unmergeable cursors) stays
    walkable.
    """

    config_error: bool = False


# --------------------------------------------------------------------------
# topology metadata
# --------------------------------------------------------------------------

def capture_topology(state: Any = None) -> Dict[str, Any]:
    """Topology document for ``manifest.json``: world size and rank count
    from ``torch.distributed`` (1 when no process group exists), the number
    of CUDA cards visible, the mesh axis sizes (all 1: the port runs at
    world size 1, see ``parallel/parallel_state.py``) and the torch and CUDA
    versions. ``state`` is accepted for the reference's signature; a torch
    train state carries no sharding to read a mesh from."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none

    ps = get_parallel_state_or_none()
    mesh_axes: Dict[str, int] = dict(ps.mesh_shape) if ps is not None else {}
    return {
        "version": TOPOLOGY_VERSION,
        "world_size": int(world),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "mesh": mesh_axes,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
    }


def mesh_incompat_reason(saved_mesh: Optional[Mapping[str, int]],
                         target_mesh: Optional[Mapping[str, int]]) -> Optional[str]:
    """Reason string when the two meshes differ on a model-parallel axis
    extent; None when compatible (or either side unknown/empty)."""
    if not saved_mesh or not target_mesh:
        return None
    for ax in MODEL_PARALLEL_AXES:
        a = int(saved_mesh.get(ax, 1))
        b = int(target_mesh.get(ax, 1))
        if a != b:
            return (
                f"model-parallel axis '{ax}' changed {a} -> {b}; elastic "
                f"restore only supports data-parallel resizes "
                f"({'/'.join(DATA_AXES)} extents, world size). Resume on a "
                f"mesh with the saved {ax} degree, or re-shard the "
                f"checkpoint offline."
            )
    return None


def classify_restore(
    saved_topology: Optional[Mapping[str, Any]],
    target_world: int,
    target_mesh: Optional[Mapping[str, int]] = None,
    rank_files: Optional[Sequence[int]] = None,
    target_device_count: Optional[int] = None,
) -> Tuple[str, str]:
    """One restore verdict shared by the checkpointer gate and the operator
    CLI: ``("ok", ...)`` same topology, ``("elastic", ...)`` data-parallel
    resize with complete mergeable sidecars, ``("incompatible", reason)``,
    or ``("unknown", reason)`` when no topology was recorded (pre-elastic
    checkpoint) and the sidecars don't line up either."""
    ranks = sorted(int(r) for r in rank_files) if rank_files is not None else None
    saved_world = None
    if saved_topology and saved_topology.get("world_size"):
        saved_world = int(saved_topology["world_size"])
    elif ranks:
        # pre-topology checkpoints: infer the saved world from the sidecars
        saved_world = max(ranks) + 1

    if saved_topology:
        reason = mesh_incompat_reason(saved_topology.get("mesh"), target_mesh)
        if reason:
            return "incompatible", reason
        expected = int(saved_topology.get("rank_state_files") or 0)
        if expected and (ranks or []) != list(range(expected)):
            # the save RECORDED how many cursor sidecars it wrote; the
            # on-disk set disagrees — torn or lost (losing ALL of them must
            # be as detectable as losing one, which a bare listing can't do)
            missing = sorted(set(range(expected)) - set(ranks or []))
            return "incompatible", (
                f"the save recorded {expected} per-rank cursor sidecar(s) "
                f"but the on-disk set is {ranks or []} (missing ranks "
                f"{missing}) — the cursor set is torn or lost; restore "
                f"from an intact generation"
            )

    if saved_world is None:
        return "unknown", (
            "no recorded topology and no per-rank sidecars; restore "
            "proceeds but cursor coverage cannot be checked"
        )
    if not saved_topology and saved_world != target_world:
        # the saved world was only INFERRED from the sidecar listing
        # (max rank + 1): a lost highest-rank sidecar is undetectable, so
        # a resize could silently merge an incomplete cursor set — refuse
        return "incompatible", (
            f"no recorded topology (pre-elastic checkpoint): the saved "
            f"world size is inferred from the sidecar listing, so there is "
            f"no proof the sidecar set is complete (a lost highest-rank "
            f"file would be undetectable) and a resize to {target_world} "
            f"cannot be trusted. Resume once on the saved world size (new "
            f"checkpoints record their topology), then resize."
        )
    if saved_world == target_world:
        if ranks is not None and ranks and ranks != list(range(saved_world)):
            return "incompatible", (
                f"sidecars present for ranks {ranks} but the saved world "
                f"size is {saved_world}; the checkpoint's per-rank cursor "
                f"set is torn — restore from an intact generation"
            )
        if saved_topology:
            # same world size but a different device mesh (e.g. a pod slice
            # shrank under the same process count): the arrays still need a
            # reshard-on-load, so the restore is elastic, not identity
            sm = dict(saved_topology.get("mesh") or {})
            tm = dict(target_mesh or {})
            if sm and tm and any(
                int(sm.get(ax, 1)) != int(tm.get(ax, 1)) for ax in DATA_AXES
            ):
                return "elastic", (
                    f"data-parallel mesh resize {sm} -> {tm} (world size "
                    f"unchanged: arrays reshard via NamedSharding, per-rank "
                    f"cursors pass through)"
                )
            sd = saved_topology.get("device_count")
            if sd and target_device_count and int(sd) != int(target_device_count):
                return "elastic", (
                    f"device count changed {sd} -> {target_device_count} "
                    f"(world size unchanged: arrays reshard via "
                    f"NamedSharding, per-rank cursors pass through)"
                )
        return "ok", f"same world size ({saved_world})"
    if ranks is not None and ranks != list(range(saved_world)):
        missing = sorted(set(range(saved_world)) - set(ranks))
        return "incompatible", (
            f"world resize {saved_world} -> {target_world} needs every "
            f"saved rank's sidecar to merge the data cursors, but ranks "
            f"{missing} are missing"
        )
    return "elastic", (
        f"data-parallel world resize {saved_world} -> {target_world}: "
        f"arrays reshard via NamedSharding, rank cursors merge/split"
    )


# --------------------------------------------------------------------------
# rank-state merge/split
# --------------------------------------------------------------------------

def _merge_skipped(per_rank: List[List[Any]]) -> List[List[Any]]:
    """Ordered union of per-rank poison-skip histories (rank order, first
    occurrence wins): every target rank carries the FULL union so a skipped
    record replays identically wherever its shard lands after the resize.

    Budget note: the per-rank ``data_skip_budget`` counts the whole
    ``skipped`` list, so after a resize each rank's FRESH tolerance shrinks
    to ``budget - len(union)`` (the saved world had ``budget`` fresh slots
    per rank past its own history). Deliberate: replay accounting must stay
    identical to the saved run's (PR 5 contract), and tightening after a
    topology change is the conservative direction — never looser."""
    seen = set()
    out: List[List[Any]] = []
    for skipped in per_rank:
        for entry in skipped or []:
            key = (str(entry[0]), int(entry[1]))
            if key in seen:
                continue
            seen.add(key)
            out.append([key[0], key[1]])
    return out


def _epoch_skew_error(epochs: List[int]) -> ElasticRestoreError:
    """Raised when saved rank cursors straddle an epoch rollover: the ahead
    ranks' finished-epoch history was RESET at their rollover (the
    per-epoch consumed map / cursor starts clean), so a world resize cannot
    reconstruct which records their old allotment covered — merging would
    silently re-train that entire allotment, not just a 'small lead'."""
    return ElasticRestoreError(
        f"saved rank cursors straddle an epoch rollover (epochs {epochs}): "
        f"the ahead ranks' finished-epoch history was reset at rollover, so "
        f"a world resize cannot tell which records their allotment already "
        f"covered. Resume on the saved world size, or resize from a "
        f"checkpoint not adjacent to an epoch boundary."
    )


def _merge_streaming(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge streaming-dataset states (globally-keyed consumed-prefix map;
    see ``StreamingShardDataset.state_dict``). With shards >= ranks each
    shard is consumed by exactly one rank, so the per-shard maps are
    disjoint; a conflict (same shard, different counts) means the sidecars
    came from inconsistent generations — take the max and warn."""
    epochs = sorted({int(s.get("epoch", 0)) for s in states})
    if len(epochs) > 1:
        raise _epoch_skew_error(epochs)
    if any(s.get("stride_records") for s in states):
        mid_epoch = any(
            int(s.get("shard_pos", 0)) or int(s.get("rec_pos", 0))
            or s.get("consumed") for s in states
        )
        if mid_epoch:
            raise ElasticRestoreError(
                "streaming corpus has fewer shards than data-parallel ranks "
                "(record-strided assignment), so mid-epoch cursors are not "
                "prefix-mergeable across a world resize. Resume on the saved "
                "world size, resume from an epoch-boundary checkpoint, or "
                "re-shard the corpus into >= world_size shards."
            )
    if any(
        (int(s.get("shard_pos", 0)) or int(s.get("rec_pos", 0)))
        and not s.get("consumed")
        for s in states
    ):
        # legacy (pre-elastic) mid-epoch cursor: only the rank-local
        # (shard_pos, rec_pos) ints exist — no globally-keyed consumed map
        # to transfer. Building an empty map would silently restart the
        # epoch from record 0, re-training everything already consumed.
        raise ElasticRestoreError(
            "streaming cursor was saved before elastic keying (rank-local "
            "shard_pos/rec_pos only, no per-shard consumed map) and cannot "
            "be transferred to a different world size. Resume once on the "
            "saved world size (any new checkpoint records the global map), "
            "or resize from an epoch-boundary checkpoint."
        )
    consumed: Dict[str, int] = {}
    for s in states:
        for key, n in (s.get("consumed") or {}).items():
            prev = consumed.get(key)
            if prev is not None and prev != int(n):
                logger.warning_rank0(
                    "elastic merge: shard %s consumed-count conflict "
                    "(%d vs %d); keeping the max", key, prev, int(n),
                )
            consumed[key] = max(int(n), prev or 0)
    return {
        "kind": "streaming",
        "epoch": epochs[0],
        "consumed": consumed,
        "skipped": _merge_skipped([s.get("skipped", []) for s in states]),
    }


#: the native DistributedDataloader's full state schema — a loader state
#: carrying keys outside this set (e.g. DynamicBatchDataloader's ``buffer``
#: / ``batches_emitted`` knapsack state) holds replay state this merge does
#: not understand; silently dropping it would lose buffered samples, so the
#: merge refuses instead.
_NATIVE_LOADER_KEYS = frozenset(
    ("epoch", "cursor", "seed", "dp_rank", "dp_size", "dataset", "collator")
)


def _merge_native(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge native ``DistributedDataloader`` states: per-rank sample
    cursors fold into a global consumed count; collator carry-over buffers
    concatenate in rank order. Cursors straddling an epoch rollover refuse
    (see :func:`_epoch_skew_error`: the ahead rank's finished-epoch cursor
    was reset, so its block would be re-trained wholesale)."""
    unknown = sorted(
        {k for s in states for k in s} - _NATIVE_LOADER_KEYS
    )
    if unknown:
        raise ElasticRestoreError(
            f"dataloader state carries keys {unknown} this elastic merge "
            f"does not understand (a stateful loader like the dynamic "
            f"batcher holds buffered samples that would be silently "
            f"dropped); resume on the saved world size"
        )
    epochs = sorted({int(s.get("epoch", 0)) for s in states})
    if len(epochs) > 1:
        raise _epoch_skew_error(epochs)
    cursors = [int(s.get("cursor", 0)) for s in states]
    pending: List[Any] = []
    dropped = 0
    for s in states:
        coll = s.get("collator") or {}
        pending.extend(coll.get("pending", []))
        dropped += int(coll.get("dropped_oversized", 0))
    merged: Dict[str, Any] = {
        "kind": "native",
        "epoch": epochs[0],
        "seed": int(states[0].get("seed", 0)),
        "cursors": cursors,
        "global_cursor": sum(cursors),
        "collator": {"pending": pending, "dropped_oversized": dropped},
    }
    ds_states = [s["dataset"] for s in states if isinstance(s.get("dataset"), dict)]
    if ds_states:
        if len(ds_states) != len(states):
            # same refusal as the loader-level asymmetry: merging only the
            # ranks that still HAVE a dataset state would drop the others'
            # consumed records from the map and silently re-train them
            raise ElasticRestoreError(
                "some saved ranks carry a nested dataset state and some do "
                "not; the sidecar set is torn — restore from an intact "
                "generation"
            )
        if all("shard_pos" in d or "consumed" in d or "skipped" in d
               for d in ds_states):
            merged["dataset"] = _merge_streaming(ds_states)
        else:
            # unknown nested dataset schema: only a no-op merge is safe
            if any(d != ds_states[0] for d in ds_states[1:]):
                raise ElasticRestoreError(
                    "per-rank dataset states differ but their schema is not "
                    "elastically mergeable; resume on the saved world size"
                )
            merged["dataset"] = dict(ds_states[0])
            merged["dataset"].setdefault("kind", "opaque")
    return merged


def merge_rank_states(
    rank_states: Mapping[int, Optional[Dict[str, Any]]],
) -> Dict[str, Any]:
    """Fold the saved per-rank sidecars (``{rank: extra_state_rank{r} doc}``)
    into one world-size-agnostic document. The original per-rank docs ride
    along under ``origin`` so a same-world split is a bit-exact passthrough.
    """
    ranks = sorted(rank_states)
    if ranks != list(range(len(ranks))):
        raise ElasticRestoreError(
            f"cannot merge a torn sidecar set (ranks {ranks}): every rank "
            f"0..N-1 of the saved world must be present"
        )
    loaders = []
    for r in ranks:
        doc = rank_states[r] or {}
        loaders.append(doc.get("dataloader"))
    merged: Dict[str, Any] = {
        "elastic_version": 1,
        "saved_world_size": len(ranks),
        "origin": {str(r): rank_states[r] for r in ranks},
    }
    real = [l for l in loaders if isinstance(l, dict)]
    if not real:
        merged["dataloader"] = None
        return merged
    if len(real) != len(loaders):
        raise ElasticRestoreError(
            "some saved ranks have a dataloader cursor and some do not; "
            "the sidecar set is torn — restore from an intact generation"
        )
    # a failed loader merge (unknown schema, epoch skew, stride regime) is
    # recorded, not raised: a SAME-world split never consults the merged
    # view (origin passthrough is byte-exact — e.g. a mesh-only resize of a
    # dynamic-batching run), so the error only becomes fatal when
    # split_rank_state is asked for a world the merge could not serve
    merged["dataloader"] = None
    try:
        # the dp_size each cursor recorded at save time must match the
        # sidecar count the filenames imply — a disagreement means the set
        # was mislabeled (files copied between runs) rather than torn
        declared = {int(l["dp_size"]) for l in real if "dp_size" in l}
        if declared and declared != {len(real)}:
            raise ElasticRestoreError(
                f"sidecar set has {len(real)} rank file(s) but the cursors "
                f"inside declare dp_size {sorted(declared)} — the set is "
                f"mislabeled or assembled from different runs; restore "
                f"from an intact generation"
            )
        if all("cursor" in l for l in real):
            merged["dataloader"] = _merge_native(real)
        elif all(("shard_pos" in l or "consumed" in l) for l in real):
            merged["dataloader"] = _merge_streaming(real)
        else:
            raise ElasticRestoreError(
                "dataloader state schema is not elastically mergeable "
                "(expected the native loader's sample cursor or the "
                "streaming dataset's consumed map); resume on the saved "
                "world size"
            )
    except ElasticRestoreError as e:
        merged["dataloader_error"] = str(e)
    return merged


def _split_streaming(merged: Dict[str, Any]) -> Dict[str, Any]:
    """Any target rank's streaming state: the FULL globally-keyed consumed
    map + skip union (each rank consults only the shards its own assignment
    visits, so sharing the whole map is both exact and world-size-free).
    The ``elastic`` marker lets the dataset refuse the one regime where the
    map's prefix semantics break: a TARGET world with fewer shards than
    ranks (record striding) — the saved side of that check lives in
    :func:`_merge_streaming`, but only the dataset knows its own shard
    count at load time."""
    return {
        "epoch": int(merged.get("epoch", 0)),
        "shard_pos": 0,
        "rec_pos": 0,
        "elastic": True,
        "consumed": dict(merged.get("consumed") or {}),
        "skipped": [list(e) for e in merged.get("skipped", [])],
    }


def _split_native(merged: Dict[str, Any], world_size: int,
                  rank: int) -> Dict[str, Any]:
    """Target rank's native-loader state. The contiguous-block sample cursor
    is only *epoch-position*-preserving across a resize (exact when every
    saved cursor is 0 — an epoch boundary); carry-over samples redistribute
    round-robin so none is lost or duplicated."""
    global_cursor = int(merged.get("global_cursor", 0))
    pending = list((merged.get("collator") or {}).get("pending", []))
    if global_cursor or pending:
        logger.warning_rank0(
            "elastic restore of a mid-epoch mapping-loader cursor "
            "(global sample position %d, %d carried-over sample(s)): the "
            "resumed run preserves the global epoch position but not exact "
            "per-sample identity (contiguous per-rank index blocks are not "
            "world-size-transferable). Checkpoint at epoch boundaries — or "
            "use the streaming dataset, whose cursors are exact — for "
            "bit-identical elastic resumes.", global_cursor, len(pending),
        )
    world = max(world_size, 1)
    out: Dict[str, Any] = {
        "epoch": int(merged.get("epoch", 0)),
        # remainder-preserving: the per-rank cursors sum back to the exact
        # global count (a plain floor-divide would quietly re-consume up to
        # world-1 samples the original run already trained on)
        "cursor": global_cursor // world + (1 if rank < global_cursor % world else 0),
        "seed": int(merged.get("seed", 0)),
        "collator": {
            "pending": pending[rank::world_size],
            "dropped_oversized": int(
                (merged.get("collator") or {}).get("dropped_oversized", 0)
            ) if rank == 0 else 0,
        },
    }
    ds = merged.get("dataset")
    if isinstance(ds, dict):
        if ds.get("kind") == "streaming" or "consumed" in ds:
            out["dataset"] = _split_streaming(ds)
        else:
            out["dataset"] = {k: v for k, v in ds.items() if k != "kind"}
    return out


def split_rank_state(merged: Dict[str, Any], world_size: int,
                     rank: int) -> Dict[str, Any]:
    """Derive rank ``rank``-of-``world_size``'s sidecar doc from a merged
    document. Same world size → the original rank doc, bit-exact."""
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    origin = merged.get("origin") or {}
    if world_size == int(merged.get("saved_world_size", -1)):
        if str(rank) in origin:
            return origin[str(rank)]
    if merged.get("dataloader_error"):
        raise ElasticRestoreError(merged["dataloader_error"])
    loader = merged.get("dataloader")
    if loader is None:
        return {"dataloader": None}
    if loader.get("kind") == "native":
        return {"dataloader": _split_native(loader, world_size, rank)}
    return {"dataloader": _split_streaming(loader)}
