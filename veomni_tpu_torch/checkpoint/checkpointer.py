"""Train-state checkpointing with exact resume.

Port of ``veomni_tpu/checkpoint/checkpointer.py``. The reference saves its
sharded TrainState with Orbax; here the state is a torch model and its
AdamW, and the payload is two ``torch.save`` files under
``global_step_N/train_state/``: ``model.pt`` (the model's ``state_dict``)
and ``optimizer.pt`` (the optimizer's ``state_dict`` with its moments, its
update count ``num_updates`` and the train step). What the reference's
contract asks of a generation stays as it is:

* the payload is written into a temporary directory and committed by an
  atomic rename to ``train_state`` (the commit marker of
  ``resilience/integrity.py``), AFTER the ``extra_state*.json`` sidecars;
* once committed, rank 0 digests the generation into ``manifest.json``;
  ``load()`` verifies it first, quarantines a failing generation to
  ``global_step_N.corrupt`` and falls back to the next-newest one;
* ``max_to_keep`` pruning, sync and async saves, bounded retries with
  ``ckpt.save``/``ckpt.restore`` fault points, and the rank-local sidecar
  of the dataloader cursor.

Async save and in-place updates. Orbax can write JAX arrays after ``save()``
returns because they are immutable. The port's AdamW updates parameters
and moments in place, so ``save()`` first copies every tensor to host
memory (pinned, for a card) and synchronizes; only the file writing runs on
the writer thread. Restore loads the files on the host first (a failure
there leaves the live state untouched), then copies them into the live
model and optimizer in place.

Across several processes (a ``layout`` from ``parallel/parallel_plan.py``)
the payload on disk is the one world size 1 writes: every rank takes part
in gathering the full model and optimizer state (collectives over the
shards), rank 0 alone writes ``model.pt``/``optimizer.pt`` and commits them
after a barrier that follows every rank's cursor sidecar, and a sync save
ends in a barrier, so no rank passes a save its commit has not reached.
A restore reads the full payload on every rank and slices it into the
rank's shards, so a generation saved at one world size restores at another
(with ``elastic``, as the reference asks of a data-parallel resize). Rank
0's verdicts are broadcast: the walk's candidate list and each manifest
verification, so every rank quarantines, falls back and restores alike.
The dataloader sidecar stays rank-local.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import shutil

import torch

from veomni_tpu_torch.observability.flight_recorder import record as flight_record
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.observability.spans import span
from veomni_tpu_torch.parallel.functional import broadcast_object
from veomni_tpu_torch.resilience.elastic import (
    ElasticRestoreError,
    capture_topology,
    classify_restore,
    merge_rank_states,
    mesh_incompat_reason,
    split_rank_state,
)
from veomni_tpu_torch.resilience.faults import fault_point
from veomni_tpu_torch.resilience.integrity import (
    QUARANTINE_DIR_RE,
    STEP_DIR_RE,
    VERIFY_MODES,
    CheckpointCorruptError,
    is_committed_dir,
    list_rank_sidecars,
    read_topology,
    verify_manifest,
    write_manifest,
)
from veomni_tpu_torch.resilience.retry import RetryPolicy, retry_call
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

# naming scheme lives in integrity.py (shared with scripts/verify_ckpt.py);
# quarantined generations: global_step_N.corrupt (rename collisions get a
# numeric suffix so a twice-quarantined step never blocks the rename)
_STEP_RE = STEP_DIR_RE
_CORRUPT_RE = QUARANTINE_DIR_RE


#: marks a payload directory that is still being written (crash debris)
_TMP_MARK = ".tmp-"
#: the payload files under ``train_state/``
PAYLOAD_FILES = ("model", "optimizer")


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def _tree_bytes(tree: Any) -> int:
    """Bytes of the tensors in a nested dict/list payload."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _optimizer_params(optimizer) -> List[torch.Tensor]:
    """The optimizer's parameters in its ``state_dict`` index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def _full_optimizer_state(opt_state: Dict[str, Any], optimizer, layout) -> Dict[str, Any]:
    """The optimizer state with every tensor gathered whole (collective):
    a moment laid out as its parameter, and a whole-leaf optimizer's (Muon,
    Adafactor) statistics cut over the world, as it cut them
    (``optim/optimizer.py::LeafOptimizer.gather_state``)."""
    if layout is None:
        return opt_state["state"]
    params = _optimizer_params(optimizer)
    if getattr(optimizer, "leaves", None) is not None:
        return {i: {k: optimizer.gather_state(params[i], k, v) for k, v in st.items()}
                for i, st in opt_state["state"].items()}
    return {i: {k: layout.full_tensor(params[i], v) if torch.is_tensor(v) and v.ndim else v
                for k, v in st.items()} for i, st in opt_state["state"].items()}


def snapshot_state(train_state, layout=None) -> Dict[str, Any]:
    """Host copy of everything a resume needs: the model's ``state_dict``,
    the optimizer's (moments, per-parameter step counts, param groups), its
    update count and the train step. Card tensors are copied into pinned
    host memory without blocking, then the card is synchronized once, so
    the snapshot is complete before the caller's next in-place update.
    With a ``layout`` every tensor is gathered whole first (every rank must
    call it)."""
    on_card = False

    def host(t):
        nonlocal on_card
        if t.device.type == "cuda":
            on_card = True
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t.detach(), non_blocking=True)
        return t.detach().clone()

    opt = train_state.optimizer.state_dict()
    model_state = (layout.full_state_dict() if layout is not None
                   else train_state.model.state_dict())
    payload = {
        "model": {k: host(v) for k, v in model_state.items()},
        "optimizer": {
            "state": {i: {k: host(v) if torch.is_tensor(v) else v for k, v in st.items()}
                      for i, st in _full_optimizer_state(opt, train_state.optimizer,
                                                         layout).items()},
            "param_groups": [dict(g, params=list(g["params"])) for g in opt["param_groups"]],
            "num_updates": int(getattr(train_state.optimizer, "num_updates", 0)),
            "step": int(train_state.step),
        },
    }
    if on_card:
        torch.cuda.synchronize()
    return payload


def load_state_into(train_state, payload: Dict[str, Any], layout=None) -> None:
    """Copy a host payload into the live model and optimizer in place; with a
    ``layout``, each rank's part of every tensor."""
    opt = payload["optimizer"]
    state = opt["state"]
    optimizer = train_state.optimizer
    if layout is None:
        train_state.model.load_state_dict(payload["model"])
    else:
        layout.load_full_state_dict(payload["model"])
        params = _optimizer_params(optimizer)
        if getattr(optimizer, "leaves", None) is not None:
            # this rank's part of each whole state tensor, cut as the update cuts it
            state = {int(i): {k: optimizer.cut_state(params[int(i)], k, v) for k, v in st.items()}
                     for i, st in state.items()}
        else:
            state = {int(i): {k: layout.to_layout(params[int(i)], v)
                              if torch.is_tensor(v) and v.ndim else v for k, v in st.items()}
                     for i, st in state.items()}
    optimizer.load_state_dict({"state": state, "param_groups": opt["param_groups"]})
    train_state.optimizer.num_updates = int(opt["num_updates"])
    train_state.step = int(opt["step"])


class _StateWriter:
    """Writes payloads under a ``train_state`` path, one save at a time on
    a writer thread, and reads them back (the part of Orbax's
    ``AsyncCheckpointer`` the checkpointer uses). A save writes every file
    into ``<path>.tmp-<pid>`` and renames that to ``<path>``: the rename is
    the commit. A failure on the thread surfaces at the next
    ``wait_until_finished()`` or ``check_for_errors()``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @staticmethod
    def _write(path: str, payload: Dict[str, Any]) -> None:
        tmp = f"{path}{_TMP_MARK}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name in PAYLOAD_FILES:
            with open(os.path.join(tmp, f"{name}.pt"), "wb") as f:
                torch.save(payload[name], f)
                f.flush()
                os.fsync(f.fileno())
        os.rename(tmp, path)

    def _run(self, path: str, payload: Dict[str, Any]) -> None:
        try:
            self._write(path, payload)
        except BaseException as e:  # surfaced on the caller's thread
            self._error = e

    def save(self, path: str, payload: Dict[str, Any]) -> None:
        self.wait_until_finished()
        self._thread = threading.Thread(target=self._run, args=(path, payload),
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def _raise_error(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_error()

    def check_for_errors(self) -> None:
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None
        if self._thread is None:
            self._raise_error()

    @staticmethod
    def restore(path: str) -> Dict[str, Any]:
        return {name: torch.load(os.path.join(path, f"{name}.pt"), map_location="cpu",
                                 weights_only=True)
                for name in PAYLOAD_FILES}

    def close(self) -> None:
        self.wait_until_finished()


class Checkpointer:
    """save/load of {train_state, extra_state} under ckpt_dir/global_step_N.

    ``train_state`` is the port's :class:`~veomni_tpu_torch.train.TrainState`
    (model, optimizer, step); see the module docstring for the payload.

    I/O resilience: every save/restore dispatch runs under a bounded
    deterministic-backoff retry (``io_retries``/``retry_base_s``), with
    ``ckpt.save``/``ckpt.restore`` fault points inside each attempt so the
    whole path is exercisable from a ``VEOMNI_FAULT_PLAN``. Async-save
    commit errors are probed at the next step boundary (``save()``/``wait()``)
    and the failed step is EVICTED from the dedupe set, so a later save of
    that step re-dispatches instead of being silently lost.

    Integrity (``resilience/integrity.py``): once a generation's commit is
    observed, rank 0 digests it into ``manifest.json``; ``load()`` verifies
    the manifest per ``verify_mode`` (``off|size|full``) BEFORE reading
    the payload, quarantines failing generations to
    ``global_step_N.corrupt``, and falls back to the next-newest
    committed-and-verified one.
    """

    def __init__(self, ckpt_dir: str, *, async_save: bool = True, max_to_keep: int = 0,
                 io_retries: int = 3, retry_base_s: float = 0.05,
                 verify_mode: str = "size", elastic: bool = False, layout=None):
        if verify_mode not in VERIFY_MODES:
            raise ValueError(
                f"unknown ckpt verify mode {verify_mode!r}; choose from {VERIFY_MODES}"
            )
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.layout = layout
        self.async_save = async_save
        self.max_to_keep = max_to_keep
        self.verify_mode = verify_mode
        # elastic restore (train.ckpt_elastic / resilience/elastic.py):
        # allow restoring a checkpoint saved on a different data-parallel
        # topology — arrays reshard via the target NamedShardings, per-rank
        # cursor sidecars merge/split. Off (default): a topology mismatch is
        # an actionable error, never a silent partial cursor restore.
        self.elastic = elastic
        # source-topology docs for the manifest, captured from the state
        # tree at each save dispatch. Keyed BY STEP: the previous async
        # step's manifest is written from inside the NEXT save(), which has
        # already captured its own doc — and rank_state_files can differ
        # between saves, so "latest" would stamp the wrong census onto the
        # prior generation
        self._topology: Optional[Dict[str, Any]] = None
        self._step_topology: Dict[int, Dict[str, Any]] = {}
        self._retry_policy = RetryPolicy(retries=io_retries, base_delay_s=retry_base_s)
        self._saved_steps: set = set()
        self._inflight_step: Optional[int] = None
        # steps condemned by a failed verify THIS process: the dir rename is
        # rank-0's job, but every rank must stop offering the step locally
        # (a lagging shared fs may still show the old name for a beat)
        self._quarantined: set = set()
        # in-flight async manifest digest (rank 0 only): the full-tree CRC
        # re-reads every committed byte, so it runs off the hot save path
        self._manifest_thread: Optional[threading.Thread] = None
        self._ckptr = _StateWriter()
        # startup is the only moment no save can be in flight anywhere, so
        # clear crashed-save debris here (never during save(): a lagging host
        # could rmtree a faster host's live tmp dir)
        self._clean_debris()

    def _clean_debris(self):
        if _process_index() != 0:  # same shared-fs race as _prune
            return
        for d in os.listdir(self.ckpt_dir):
            if not _STEP_RE.match(d):
                continue
            step_dir = os.path.join(self.ckpt_dir, d)
            if not os.path.isdir(os.path.join(step_dir, "train_state")):
                # crash before commit: only tmp payload/extra_state remain
                logger.warning_rank0("removing uncommitted checkpoint debris %s", d)
                shutil.rmtree(step_dir, ignore_errors=True)
            else:
                for sub in os.listdir(step_dir):
                    if _TMP_MARK in sub:
                        shutil.rmtree(os.path.join(step_dir, sub), ignore_errors=True)
        self._reap_quarantined()

    def _reap_quarantined(self):
        """Age out ``.corrupt`` quarantined generations beyond ``max_to_keep``
        (rank-0-gated like ``_prune``). Quarantine keeps the bytes around for
        post-mortem, but a flaky filesystem would otherwise leak disk forever;
        the newest ``max_to_keep`` corpses stay, older ones are reaped.
        ``max_to_keep == 0`` (keep-everything semantics, same as _prune)
        never reaps."""
        if not self.max_to_keep or _process_index() != 0:
            return
        import shutil

        corpses = []
        for d in os.listdir(self.ckpt_dir):
            m = _CORRUPT_RE.match(d)
            if m:
                corpses.append((int(m.group(1)), d))
        for _step, d in sorted(corpses)[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)
            logger.warning_rank0("reaped quarantined checkpoint %s", d)

    # ------------------------------------------------------------------ save
    def check_for_errors(self) -> Optional[BaseException]:
        """Step-boundary probe of the async commit thread. On failure the
        in-flight step is evicted from the dedupe set (so a later ``save()``
        of that step re-dispatches instead of silently skipping) and the
        error is returned for the caller to surface or absorb."""
        probe = getattr(self._ckptr, "check_for_errors", None)
        if probe is None:
            return None
        try:
            probe()
        except Exception as e:
            self._evict_inflight(e)
            return e
        return None

    def _evict_inflight(self, err: BaseException) -> None:
        if self._inflight_step is not None:
            self._saved_steps.discard(self._inflight_step)
            logger.error(
                "async checkpoint save of step %d FAILED: %s; step evicted — "
                "the next save() of it will retry", self._inflight_step, err,
            )
            self._inflight_step = None

    def _dispatch_save(self, path: str, payload, step_dir: str,
                       extra_state, rank_state) -> None:
        """One save attempt (the retried unit): sidecar JSONs, then the
        payload dispatch. The JSON writes sit INSIDE the unit so a transient
        shared-fs error there is retried like any other I/O (re-writing them
        is idempotent), and BEFORE the payload so the atomic ``train_state``
        rename can never commit a checkpoint missing its cursor metadata.
        The serialization wait on the PREVIOUS async save lives in save(),
        outside this unit: a previous commit's failure must evict ITS step,
        not be retried away as a transient fault of this one. The sync-mode
        wait stays inside — that failure IS this step's, and re-dispatching
        is the right retry."""
        os.makedirs(step_dir, exist_ok=True)
        if extra_state is not None and _process_index() == 0:
            with open(os.path.join(step_dir, "extra_state.json"), "w") as f:
                json.dump(extra_state, f)
        if rank_state is not None:
            # per-process state (dataloader cursor + packing carry-over is
            # rank-local data!): every process writes its own file — restoring
            # rank 0's buffer everywhere would feed all ranks rank-0's samples
            fname = f"extra_state_rank{_process_index()}.json"
            with open(os.path.join(step_dir, fname), "w") as f:
                json.dump(rank_state, f)
        fault_point("ckpt.save")
        if _process_count() > 1:
            _barrier()  # every rank's sidecar is on disk before rank 0 commits
        if _process_index() != 0:
            return  # rank 0 writes the (gathered) payload
        self._ckptr.save(path, payload)
        if not self.async_save:
            self._ckptr.wait_until_finished()

    def save(self, step: int, train_state, extra_state: Optional[Dict[str, Any]] = None,
             rank_state: Optional[Dict[str, Any]] = None):
        # surface a failed PREVIOUS async save now (and evict its step) —
        # never inside the jitted loop, only at this step boundary
        self.check_for_errors()
        path = os.path.join(self.ckpt_dir, f"global_step_{step}", "train_state")
        # in-memory dedupe: async saves only materialize the dir at commit, so
        # isdir alone would race an in-flight save of the same step
        if step in self._saved_steps:
            logger.info_rank0("checkpoint for step %d already dispatched; skipping", step)
            return
        # a quarantined step is being SUPERSEDED by this save: the condemned
        # dir was renamed away by rank 0 — but if that rename itself failed
        # (flaky shared fs), the corpse still occupies the path and the
        # payload rename would fail with an unretried "destination exists"
        if step in self._quarantined:
            self._clear_corpse(step)
        elif broadcast_object(os.path.isdir(path)):  # rank 0's view, on every rank
            logger.info_rank0("checkpoint for step %d already exists; skipping", step)
            return
        # serialize with any in-flight save BEFORE the retried dispatch: if
        # the previous async commit failed, the error raises here, belongs to
        # the previous step, and must evict that step — not be swallowed by
        # this step's retry loop
        # source topology for the manifest (mesh axis sizes, world size —
        # resilience/elastic.py): captured from the state tree's shardings
        # here, at dispatch, so the commit-time manifest writer (possibly a
        # daemon thread) never touches device state itself.
        # rank_state_files records how many cursor sidecars this save
        # writes: the restore gate checks the on-disk set against it, so
        # losing ALL sidecars to rot is as detectable as losing one (the
        # directory listing alone cannot tell "all lost" from "none saved")
        self._topology = dict(
            capture_topology(train_state),
            rank_state_files=(
                _process_count() if rank_state is not None else 0
            ),
        )
        self._step_topology[step] = self._topology
        # the span is the single timing source (histogram ``span.ckpt.save``
        # + goodput checkpoint attribution + chrome trace): async saves
        # measure the host-blocking dispatch (serialize-with-previous +
        # device->host copy), sync saves the full commit — either way, the
        # wall time the step loop lost
        with span("ckpt.save"):
            # the host snapshot (device -> pinned host copy + one sync): the
            # async writer thread must never see a tensor the next step
            # updates in place
            payload = snapshot_state(train_state, self.layout)
            if _process_index() != 0:
                payload = {name: {} for name in PAYLOAD_FILES}
            try:
                self._ckptr.wait_until_finished()
            except Exception as e:
                self._evict_inflight(e)
            else:
                # the PREVIOUS async save just committed: its bytes are now
                # final, so this is the earliest safe moment to digest them —
                # in the background, so the full-tree CRC read doesn't stall
                # this save boundary (joined at the next wait()/load())
                if self._inflight_step is not None:
                    flight_record("ckpt.commit", cid=str(self._inflight_step))
                    self._start_manifest(self._inflight_step)
                    self._inflight_step = None
            step_dir = os.path.join(self.ckpt_dir, f"global_step_{step}")
            retry_call(
                self._dispatch_save, path, payload, step_dir,
                extra_state, rank_state,
                policy=self._retry_policy,
                description=f"checkpoint save (step {step})",
            )
        reg = get_registry()
        reg.counter("ckpt.saves").inc()
        reg.counter("ckpt.saved_bytes").inc(_tree_bytes(payload))
        flight_record("ckpt.save", cid=str(step), async_save=self.async_save)
        # dedupe only records a SUCCESSFUL dispatch (on failure the raise
        # above leaves the set untouched, so a later attempt of this step —
        # e.g. the train-end final save — isn't silently skipped)
        self._saved_steps.add(step)
        # the fresh generation replaces any condemned one at this step:
        # list_steps/latest_step must offer it again once committed
        self._quarantined.discard(step)
        self._inflight_step = step if self.async_save else None
        if not self.async_save:  # sync: committed right here
            flight_record("ckpt.commit", cid=str(step))
            self._write_manifest(step)
            if _process_count() > 1:
                _barrier()
        logger.info_rank0("checkpoint save dispatched: step %d -> %s", step, path)
        self._prune()

    def wait(self):
        with span("ckpt.wait"):
            try:
                self._ckptr.wait_until_finished()
            except Exception as e:
                self._evict_inflight(e)
                raise
            err = self.check_for_errors()
            if err is not None:
                raise err
            # wait() is the explicit durability barrier: the manifest must be
            # on disk when it returns, so the inflight digest runs inline
            self._join_manifest()
            if self._inflight_step is not None:
                flight_record("ckpt.commit", cid=str(self._inflight_step))
                self._write_manifest(self._inflight_step)
            self._inflight_step = None

    # ------------------------------------------------------------- integrity
    def _start_manifest(self, step: int) -> None:
        """Digest a just-committed async generation off the hot save path —
        a synchronous full-tree CRC would stall rank 0 at every save boundary
        and make it a straggler at the next collective, exactly the
        host-blocking async save exists to avoid. Serialized: any previous
        digest is joined first, so manifest fault hits stay deterministic."""
        self._join_manifest()
        if _process_index() != 0:
            return
        if self.verify_mode == "off":
            # no digests to compute — the topology-only manifest is an O(1)
            # write, so it runs inline instead of on a thread
            self._write_manifest(step)
            return
        t = threading.Thread(
            target=self._write_manifest, args=(step,),
            name=f"ckpt-manifest-{step}", daemon=True,
        )
        t.start()
        self._manifest_thread = t

    def _join_manifest(self) -> None:
        t = self._manifest_thread
        if t is not None:
            t.join()
            self._manifest_thread = None
    def _write_manifest(self, step: int) -> None:
        """Rank 0 digests the committed generation into ``manifest.json``
        (the verify gate's ground truth, written NEXT to the extra-state
        sidecars). Never fatal: a failed manifest write leaves an
        unverifiable-but-healthy checkpoint, which ``load()`` accepts with a
        warning — refusing it would turn the safety net into a data killer.

        ``verify_mode == 'off'`` skips the digest entirely: "trust the
        bytes" must not cost a full-tree read of every committed byte per
        save (inline for sync saves!) to record CRCs nothing will consume —
        but the SOURCE TOPOLOGY (mesh axis sizes, world size, torch versions;
        ``resilience/elastic.py``) is still recorded, an O(1) write, so
        every generation stays diagnosable and elastically restorable.
        ``size`` mode still records digests — its manifests feed the
        operator CLI's out-of-band ``--mode full`` sweep, not just its own
        gate."""
        if _process_index() != 0:
            return
        step_dir = os.path.join(self.ckpt_dir, f"global_step_{step}")
        if not self._is_committed(step):
            return
        try:
            with span("ckpt.manifest"):
                write_manifest(
                    step_dir,
                    topology=self._step_topology.pop(step, self._topology),
                    digests=self.verify_mode != "off",
                )
            # drill point: a corrupt-mode fault spec here damages the
            # just-committed generation AFTER its digests were recorded —
            # exactly the storage-rot timeline the verify gate exists for.
            # Inside the try: an exception-mode spec must stay never-fatal
            # like any manifest failure (sync saves call this inline, async
            # ones from a daemon thread where a raise would vanish)
            fault_point("ckpt.manifest", context={"dir": step_dir})
        except Exception as e:
            logger.warning_rank0(
                "manifest write for step %d failed: %s (generation stays "
                "restorable, just unverifiable)", step, e,
            )
            return

    def verify_step(self, step: int):
        """Manifest verification per ``self.verify_mode``. Returns the
        :class:`VerifyReport`, or None when verification is off or the
        generation has no readable manifest (unverifiable ≠ corrupt: a crash
        can land between payload commit and manifest write, and pre-integrity
        checkpoints have no manifest at all)."""
        if self.verify_mode == "off":
            return None
        step_dir = os.path.join(self.ckpt_dir, f"global_step_{step}")
        report = verify_manifest(step_dir, mode=self.verify_mode)
        if report is None:
            logger.warning_rank0(
                "checkpoint step %d has no readable manifest; restoring "
                "UNVERIFIED", step,
            )
            return None
        reg = get_registry()
        reg.histogram("integrity.verify_s").observe(report.elapsed_s)
        if report.passed:
            reg.counter("integrity.ckpt_verified").inc()
        return report

    def _verify_gate(self, step: int) -> None:
        """Restore gate: a generation that fails verification is
        quarantined and raises :class:`CheckpointCorruptError`, so the
        fallback walk moves on. An errored verify is unverifiable, not
        corrupt: restore proceeds with a warning."""
        if self.verify_mode == "off":
            return
        failed = report = None
        if _process_index() == 0:  # rank 0 verifies; its verdict is every rank's
            try:
                report = self.verify_step(step)
            except Exception as e:
                logger.warning_rank0(
                    "manifest verification of step %d errored: %s; "
                    "restoring UNVERIFIED", step, e,
                )
                report = None
            if report is not None and not report.passed:
                failed = report.summary()
        failed = broadcast_object(failed)
        if failed is not None:
            reason = failed
            self._quarantine(step, reason)
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed '{self.verify_mode}' "
                f"verification and was quarantined: {reason}",
                report,
            )

    def _quarantine(self, step: int, reason: str) -> None:
        """Condemn a generation that failed verification: atomic rename to
        ``global_step_N.corrupt`` (rank-0-gated like ``_prune``) so no later
        ``list_steps``/``latest_step`` can ever offer it again, while the
        bytes stay on disk for post-mortem until ``_reap_quarantined`` ages
        them out."""
        self._quarantined.add(step)
        # un-dedupe: a later legitimate save() of this step must dispatch a
        # fresh generation, not be skipped as "already dispatched"
        self._saved_steps.discard(step)
        get_registry().counter("integrity.ckpt_quarantined").inc()
        flight_record("ckpt.quarantine", cid=str(step), reason=reason[:200])
        logger.error("QUARANTINING checkpoint step %d: %s", step, reason)
        if _process_index() != 0:
            return  # rename is rank 0's job; the in-memory set covers this rank
        self._rename_corpse(step)

    def _rename_corpse(self, step: int) -> bool:
        """Rank 0: move ``global_step_N`` aside to ``global_step_N.corrupt``
        (collision-suffixed). Returns True iff the step path is gone after
        the attempt — a failed rename is logged, never raised, because the
        in-memory ``_quarantined`` set already excludes the step."""
        src = os.path.join(self.ckpt_dir, f"global_step_{step}")
        dst = src + ".corrupt"
        k = 0
        while os.path.exists(dst):
            k += 1
            dst = src + f".corrupt.{k}"
        try:
            os.rename(src, dst)
            logger.error("quarantined %s -> %s", src, dst)
            return True
        except OSError as e:
            logger.error(
                "quarantine rename of %s failed: %s (step stays excluded "
                "in-memory)", src, e,
            )
            return not os.path.exists(src)

    def _clear_corpse(self, step: int) -> None:
        """A condemned generation is being SUPERSEDED by a fresh ``save()``
        of the same step. Normally the quarantine rename already moved the
        dir aside and this is a no-op; if that rename failed (flaky shared
        fs), the corpse still occupies the path and the payload rename would
        die on an unretried "destination already exists". Retry the move
        now, falling back to deletion — the bytes were condemned anyway."""
        if _process_index() != 0:
            return
        src = os.path.join(self.ckpt_dir, f"global_step_{step}")
        if not os.path.isdir(src):
            return
        if self._rename_corpse(step):
            return
        import shutil

        shutil.rmtree(src, ignore_errors=True)
        if os.path.exists(src):
            logger.error(
                "could not clear condemned checkpoint dir %s; the "
                "superseding save of step %d may fail", src, step,
            )
        else:
            logger.warning_rank0(
                "deleted condemned checkpoint dir %s (quarantine rename had "
                "failed) to clear the path for a superseding save", src,
            )

    def _prune(self):
        if not self.max_to_keep:
            return
        # single-rank deletion: every process calls save(), but on a shared
        # filesystem N ranks racing rmtree over the same step dirs hit
        # ENOENT on each other's half-deleted trees (ignore_errors hides the
        # error but not a torn delete racing a concurrent lister)
        if _process_index() != 0:
            return
        steps = sorted(self.list_steps())
        for s in steps[: -self.max_to_keep]:
            import shutil

            shutil.rmtree(os.path.join(self.ckpt_dir, f"global_step_{s}"), ignore_errors=True)
        self._reap_quarantined()

    # ------------------------------------------------------------------ load
    def _dispatch_restore(self, path: str):
        """One restore attempt (the retried unit): read the payload into
        host memory. Transient shared-fs failures retry here; a CORRUPT
        checkpoint keeps failing and falls through to ``load()``'s
        walk-back over earlier committed steps."""
        fault_point("ckpt.restore")
        return self._ckptr.restore(path)

    def _is_committed(self, step: int) -> bool:
        """True iff the step's payload finished committing — the commit
        marker predicate lives in integrity.py (shared with write_manifest
        and scripts/verify_ckpt.py): a stale ``train_state.tmp-*``
        *sibling* from an earlier crashed save must not invalidate a later
        successful one."""
        return is_committed_dir(
            os.path.join(self.ckpt_dir, f"global_step_{step}")
        )

    def list_steps(self):
        out = []
        if os.path.isdir(self.ckpt_dir):
            for d in os.listdir(self.ckpt_dir):
                m = _STEP_RE.match(d)
                if not m:
                    continue
                s = int(m.group(1))
                # locally-condemned steps stay invisible even if the rank-0
                # quarantine rename hasn't propagated over the shared fs yet
                if s in self._quarantined:
                    continue
                if self._is_committed(s):
                    out.append(s)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def load(self, train_state, step: Optional[int] = None,
             max_step: Optional[int] = None):
        """Restore into the live ``train_state`` (model and optimizer, in
        place). Returns (train_state, extra), or (None, None) when there is
        no committed generation.

        ``step=None`` walks newest-first over committed-and-verified
        generations (optionally capped at ``max_step`` — the supervisor's
        rollback uses this to stay before the anomalous window): a generation
        that fails manifest verification is QUARANTINED and the walk falls
        back to the next-newest one. If every generation fails verification
        the run aborts cleanly with the full quarantine history; any other
        restore failure (e.g. a payload no longer matching the model) is
        systemic and surfaces as-is."""
        if step is None:
            last_err = None
            all_corrupt = True
            candidates = broadcast_object([s for s in reversed(self.list_steps())
                                           if max_step is None or s <= max_step])
            for i, cand in enumerate(candidates):
                try:
                    return self.load(train_state, step=cand)
                except Exception as e:
                    if getattr(e, "config_error", False):
                        # config-class topology error (elastic knob off on a
                        # resized world, model-parallel degree change):
                        # walking past it could land on a stale PRE-resize
                        # generation and silently lose every step since —
                        # strictly worse than this actionable error
                        raise
                    last_err = e
                    all_corrupt = all_corrupt and isinstance(
                        e, CheckpointCorruptError
                    )
                    if i + 1 < len(candidates):
                        # integrity.ckpt_fallbacks means "walked past storage
                        # rot" (/healthz + bench surface it next to the
                        # quarantine count) — a fallback past a transient
                        # restore failure is NOT an integrity incident and
                        # must not send an operator hunting for .corrupt
                        # dirs that don't exist
                        reg = get_registry()
                        reg.counter("ckpt.restore_fallbacks").inc()
                        flight_record(
                            "ckpt.fallback", cid=str(cand),
                            to=candidates[i + 1],
                            corrupt=isinstance(e, CheckpointCorruptError),
                        )
                        if isinstance(e, CheckpointCorruptError):
                            reg.counter("integrity.ckpt_fallbacks").inc()
                        logger.warning_rank0(
                            "restore of step %d failed: %s; falling back to "
                            "step %d", cand, e, candidates[i + 1],
                        )
                    else:
                        logger.warning_rank0(
                            "restore of step %d failed: %s; no earlier "
                            "committed generation remains", cand, e,
                        )
            if last_err is not None:
                if all_corrupt:
                    raise CheckpointCorruptError(
                        f"every committed checkpoint generation under "
                        f"{self.ckpt_dir} failed {self.verify_mode} "
                        f"verification (tried {candidates}; all quarantined "
                        f"as *.corrupt). The run has no trustworthy state to "
                        f"resume from — inspect the quarantined dirs with "
                        f"scripts/verify_ckpt.py, restore from off-site "
                        f"backup, or restart from scratch."
                    ) from last_err
                raise last_err
            return None, None
        self.wait()
        step_dir = os.path.join(self.ckpt_dir, f"global_step_{step}")
        path = os.path.join(step_dir, "train_state")
        # cheap topology classification FIRST: mismatches no verification
        # changes (model-parallel degree change; data-parallel resize with
        # elastic OFF) raise here on metadata alone, so the walk never pays a
        # full-CRC verify per generation to rediscover a config error
        verdict, reason, rank_files = self._classify_step(
            step_dir, train_state
        )
        # verification gates the restore: the payload reader must never be
        # handed bytes the manifest condemns (its failure modes on corrupt
        # input are not guaranteed to be loud). It also keeps quarantine precedence
        # over a sidecar-based "incompatible" verdict: a missing rank
        # sidecar is often just storage rot the digest manifest condemns,
        # and that generation must be quarantined, not merely refused
        self._verify_gate(step)
        if verdict == "incompatible":
            raise ElasticRestoreError(
                f"checkpoint step {step} cannot be restored onto this "
                f"topology: {reason}"
            )
        rank_extra, elastic_event = self._materialize_rank_state(
            step, step_dir, verdict, reason, rank_files
        )
        with span("ckpt.restore"):
            payload = retry_call(
                self._dispatch_restore, path,
                policy=self._retry_policy,
                description=f"checkpoint restore (step {step})",
            )
            load_state_into(train_state, payload, self.layout)
        restored = train_state
        reg = get_registry()
        reg.counter("ckpt.restores").inc()
        reg.counter("ckpt.restored_bytes").inc(_tree_bytes(payload))
        flight_record("ckpt.restore", cid=str(step))
        extra = None
        extra_path = os.path.join(step_dir, "extra_state.json")
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        if rank_extra is not None:
            if extra is None:
                extra = {}
            extra.update(rank_extra)
        if elastic_event is not None:
            # counted only AFTER the array restore landed: a restore that
            # reshards its cursors but then fails (and falls back) must not
            # read as a completed topology crossing in /healthz
            reg.counter("ckpt.elastic_restores").inc()
            flight_record("ckpt.reshard", cid=str(step), **elastic_event)
            logger.warning_rank0(
                "ELASTIC restore of checkpoint step %d: %s",
                step, elastic_event["reason"],
            )
        logger.info_rank0("checkpoint restored from step %d", step)
        return restored, extra

    # -------------------------------------------------------------- elastic
    def _reshard_rank_state(self, step_dir: str, rank_files: List[int],
                            world: int, rank: int) -> Dict[str, Any]:
        """One elastic merge/split attempt (the retried unit): read EVERY
        saved rank's sidecar, fold them into the world-size-agnostic doc,
        and derive this rank's cursor on the new world size
        (``resilience/elastic.py``). Deterministic on every rank — all
        processes read the same files and the merge/split is pure."""
        fault_point("ckpt.reshard", context={"dir": step_dir})
        states: Dict[int, Optional[Dict[str, Any]]] = {}
        for r in rank_files:
            with open(os.path.join(step_dir, f"extra_state_rank{r}.json")) as f:
                states[r] = json.load(f)
        return split_rank_state(merge_rank_states(states), world, rank)

    def _classify_local(
        self, step_dir: str, train_state,
    ) -> "tuple[str, str, List[int], bool]":
        """``(verdict, reason, rank sidecar list, config_error)`` from
        metadata alone (manifest topology + directory listing; never the
        payload bytes). ``config_error`` marks the mismatches no amount of
        verification changes: a model-parallel degree change, or a
        data-parallel resize with ``elastic`` OFF — the knob error names
        the fix instead of the pre-elastic silent behavior (grown ranks
        left with empty cursors repeating/skipping samples, shrunk worlds
        dropping the missing ranks' records)."""
        rank_files = list_rank_sidecars(step_dir)
        saved_topo = read_topology(step_dir)
        if not rank_files and saved_topo is None:
            return "none", "", rank_files, False  # pre-cursor checkpoint
        current = capture_topology(train_state)
        verdict, reason = classify_restore(
            saved_topo, _process_count(),
            target_mesh=current.get("mesh"),
            rank_files=rank_files or None,
            target_device_count=current.get("device_count"),
        )
        if verdict == "incompatible" and mesh_incompat_reason(
            (saved_topo or {}).get("mesh"), current.get("mesh")
        ):
            # config-class subtype: a model-parallel degree change applies
            # to the run as a whole (the walk aborts), unlike
            # per-generation damage such as a torn sidecar set — the check
            # itself lives once, inside classify_restore; this call only
            # subtypes its verdict
            return "incompatible", (
                f"checkpoint in {step_dir} cannot be restored onto this "
                f"topology: {reason}"
            ), rank_files, True
        if verdict == "elastic" and not self.elastic:
            return "elastic", (
                f"checkpoint in {step_dir} was saved on a different "
                f"topology ({reason}) and elastic restore is OFF. Set "
                f"train.ckpt_elastic=true to reshard the arrays and "
                f"merge/split the per-rank data cursors onto this topology, "
                f"or resume on the saved one."
            ), rank_files, True
        return verdict, reason, rank_files, False

    def _classify_step(
        self, step_dir: str, train_state,
    ) -> "tuple[str, str, List[int]]":
        """Topology classification. Config-class mismatches raise here (the
        walk aborts); a sidecar-based ``incompatible`` verdict is RETURNED so
        the verify gate keeps quarantine precedence (a missing sidecar is
        often storage rot the digest manifest condemns)."""
        verdict, reason, rank_files, config = self._classify_local(
            step_dir, train_state
        )
        if config:
            err = ElasticRestoreError(reason)
            err.config_error = True  # applies to the run, not one generation
            raise err
        return verdict, reason, rank_files

    def _materialize_rank_state(
        self, step: int, step_dir: str, verdict: str, reason: str,
        rank_files: List[int],
    ) -> "tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]]]":
        """``(per-rank extra state, elastic event-or-None)`` for this
        process. Same topology: this rank's own sidecar, byte-exact. An
        ``elastic`` verdict (knob already checked in ``_classify_step``):
        merge/split of all saved sidecars — the returned event is counted
        by ``load()`` only once the array restore lands, so a resize whose
        restore then fails never reads as a completed topology crossing."""
        if verdict == "none":
            return None, None
        if verdict in ("ok", "unknown"):
            if verdict == "unknown":
                logger.warning_rank0(
                    "checkpoint step %d: %s", step, reason,
                )
            return self._read_own_sidecar(step_dir), None
        # verdict == "elastic"
        world = _process_count()
        rank = _process_index()
        if not rank_files:
            # mesh-only resize with no cursor sidecars: arrays reshard via
            # the target NamedShardings; there is no cursor to bridge
            resolved = None
        else:
            resolved = retry_call(
                self._reshard_rank_state, step_dir, rank_files, world, rank,
                policy=self._retry_policy,
                description=f"elastic cursor reshard (step {step})",
            )
        event = {
            "saved_world": len(rank_files)
            or (read_topology(step_dir) or {}).get("world_size"),
            "world": world,
            "reason": reason[:200],
        }
        return resolved, event

    def _read_own_sidecar(self, step_dir: str) -> Optional[Dict[str, Any]]:
        rank_path = os.path.join(
            step_dir, f"extra_state_rank{_process_index()}.json"
        )
        if not os.path.exists(rank_path):
            return None
        with open(rank_path) as f:
            return json.load(f)

    def close(self):
        self._ckptr.wait_until_finished()
        self._join_manifest()
        # same contract as wait(): a final async save committed by this
        # close must not leave the newest — most likely to be restored —
        # generation without its manifest (or without its ckpt.commit flight
        # event — a post-mortem must not show it saved-but-never-committed)
        if self._inflight_step is not None:
            flight_record("ckpt.commit", cid=str(self._inflight_step))
            self._write_manifest(self._inflight_step)
            self._inflight_step = None
        self._ckptr.close()


def build_checkpointer(ckpt_dir: str, ckpt_manager: str = "orbax", **kwargs) -> Checkpointer:
    """Reference ``build_checkpointer`` (checkpoint/checkpointer.py:30).
    ``orbax`` (the reference's default) and ``dcp`` both name this
    checkpointer, so a reference config runs unchanged."""
    if ckpt_manager not in ("orbax", "dcp"):
        raise ValueError(f"unknown ckpt_manager {ckpt_manager!r}")
    return Checkpointer(ckpt_dir, **kwargs)
