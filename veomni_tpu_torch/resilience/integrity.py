"""End-to-end artifact integrity: streaming CRC32 digests + manifest verify.

PR 3's recovery machinery (retry, rollback, SIGTERM resume) assumes the bytes
it falls back onto are good — a truncated or bit-flipped checkpoint payload
makes ``latest_step() -> load()`` the single point of failure for the whole
run. This module closes that loop: every committed checkpoint generation gets
a ``manifest.json`` (relative path -> size + crc32, stdlib ``zlib.crc32``
streamed in chunks), and restore verifies the manifest BEFORE handing the
directory to Orbax. A failed verification classifies each bad entry
(``missing`` / ``truncated`` / ``mismatch``) into a :class:`VerifyReport` so
the checkpointer can quarantine the generation and fall back, and
``scripts/verify_ckpt.py`` can tell an operator exactly which file rotted.

Deliberately **jax-free**: importable by the operator CLI without touching a
backend, and trivially reusable for any on-disk artifact tree.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1

# checkpoint-generation naming scheme — the single definition shared by the
# checkpointer and the operator CLI (scripts/verify_ckpt.py), so a change to
# e.g. the quarantine collision suffix can never leave the two disagreeing
STEP_DIR_RE = re.compile(r"^global_step_(\d+)$")
QUARANTINE_DIR_RE = re.compile(r"^global_step_(\d+)\.corrupt(\.\d+)?$")
#: per-process cursor sidecar naming — shared by the checkpointer's elastic
#: restore gate and the operator CLI's ELASTIC-OK verdict (same
#: single-definition rule as the regexes above: the two must never disagree
#: on which files make a rank set complete)
RANK_SIDECAR_RE = re.compile(r"^extra_state_rank(\d+)\.json$")


def list_rank_sidecars(step_dir: str) -> List[int]:
    """Sorted ranks with an ``extra_state_rank{N}.json`` sidecar in
    ``step_dir``."""
    out = []
    for fname in os.listdir(step_dir):
        m = RANK_SIDECAR_RE.match(fname)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)

#: payload subdir whose existence IS the commit marker (Orbax renames its
#: tmp dir here atomically on commit) — same single-definition rule as the
#: regexes above: the checkpointer, write_manifest, and the operator CLI
#: must never disagree on what "committed" means
TRAIN_STATE_DIR = "train_state"


def is_committed_dir(step_dir: str) -> bool:
    """True iff ``step_dir`` holds a fully-committed payload. A crashed
    async save leaves only ``*.orbax-checkpoint-tmp-*`` debris (and possibly
    eagerly-written sidecars); the final payload dir existing is the
    atomic-rename commit marker."""
    return os.path.isdir(os.path.join(step_dir, TRAIN_STATE_DIR))

#: verify-mode knob values (``train.ckpt_verify``): ``off`` skips the gate,
#: ``size`` checks existence + byte size (catches truncation/missing files —
#: the dominant real-world corruption — at directory-listing cost), ``full``
#: additionally re-digests every file (catches bit flips; reads every byte).
VERIFY_MODES = ("off", "size", "full")

_CHUNK = 1 << 20


class CheckpointCorruptError(RuntimeError):
    """A checkpoint generation failed manifest verification.

    Deliberately NOT an ``OSError``: corruption is persistent, so the retry
    layer must not burn its budget re-reading the same bad bytes — the
    caller's response is quarantine + fallback, not retry.
    """

    def __init__(self, message: str, report: Optional["VerifyReport"] = None):
        super().__init__(message)
        self.report = report


class ShardRecordError(RuntimeError):
    """A streaming shard record failed to decode or validate.

    Carries full provenance (shard path + record index + the original
    decode error) so bad-shard triage never starts from a bare
    ``JSONDecodeError``. NOT an ``OSError``: a rotten record is persistent,
    so the retry layer must not burn its budget re-reading it — the
    dataset's poison-skip budget (or fail-fast) is the response.
    """

    def __init__(self, shard: str, record: int, cause: BaseException,
                 detail: str = ""):
        self.shard = shard
        self.record = record
        self.cause = cause
        extra = f" ({detail})" if detail else ""
        super().__init__(
            f"undecodable record {record} in shard {shard}{extra}: "
            f"{type(cause).__name__}: {cause}"
        )


def crc32_file(path: str) -> Tuple[int, int]:
    """Streaming ``(crc32, size)`` of one file (bounded memory)."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def digest_tree(root: str, base: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """``{relpath: {"size": int, "crc32": "%08x"}}`` over every regular file
    under ``root``; ``relpath`` is relative to ``base`` (default ``root``) so
    a manifest can cover several subtrees of one checkpoint dir. Sorted for
    byte-stable manifests."""
    base = base or root
    out: Dict[str, Dict[str, Any]] = {}
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fname in sorted(filenames):
            full = os.path.join(dirpath, fname)
            if not os.path.isfile(full):  # sockets/broken symlinks
                continue
            crc, size = crc32_file(full)
            rel = os.path.relpath(full, base)
            out[rel] = {"size": size, "crc32": f"{crc:08x}"}
    return out


@dataclass
class VerifyProblem:
    """One bad manifest entry. ``kind``: ``missing`` (file gone),
    ``truncated`` (shorter than recorded), ``mismatch`` (longer, or crc32
    differs under ``full``)."""

    path: str
    kind: str
    detail: str

    def __str__(self) -> str:
        return f"{self.path}: {self.kind} ({self.detail})"


@dataclass
class VerifyReport:
    """Outcome of one manifest verification pass."""

    root: str
    mode: str
    total: int = 0
    problems: List[VerifyProblem] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def passed(self) -> bool:
        return not self.problems

    def summary(self) -> str:
        if self.passed:
            return (
                f"{self.root}: OK ({self.total} file(s), mode={self.mode}, "
                f"{self.elapsed_s:.3f}s)"
            )
        head = "; ".join(str(p) for p in self.problems[:4])
        more = len(self.problems) - 4
        if more > 0:
            head += f"; +{more} more"
        return (
            f"{self.root}: CORRUPT — {len(self.problems)}/{self.total} "
            f"file(s) bad (mode={self.mode}): {head}"
        )


def write_manifest(
    step_dir: str,
    subtrees: Tuple[str, ...] = (TRAIN_STATE_DIR,),
    include_sidecars: bool = True,
    topology: Optional[Dict[str, Any]] = None,
    digests: bool = True,
) -> str:
    """Digest ``step_dir``'s payload subtrees (+ ``extra_state*.json``
    sidecars) into ``step_dir/manifest.json``. Atomic: written to a tmp name
    then renamed, so a crashed writer can never leave a half manifest that
    later condemns a healthy checkpoint.

    ``topology`` (see ``resilience/elastic.py``) rides along so an elastic
    restore — or an operator with ``scripts/verify_ckpt.py`` — can tell what
    mesh/world wrote the generation. ``digests=False`` records ONLY the
    topology (``files`` stays empty, an O(1) write): ``ckpt_verify=off``
    must not cost a full-tree CRC read per save, but the checkpoint should
    still be diagnosable; :func:`verify_manifest` treats a digest-free
    manifest as unverifiable, never as verified-clean."""
    files: Dict[str, Dict[str, Any]] = {}
    if digests:
        for sub in subtrees:
            root = os.path.join(step_dir, sub)
            if os.path.isdir(root):
                files.update(digest_tree(root, base=step_dir))
        if include_sidecars:
            for fname in sorted(os.listdir(step_dir)):
                if fname.startswith("extra_state") and fname.endswith(".json"):
                    crc, size = crc32_file(os.path.join(step_dir, fname))
                    files[fname] = {"size": size, "crc32": f"{crc:08x}"}
    doc: Dict[str, Any] = {"version": MANIFEST_VERSION, "files": files}
    if topology is not None:
        doc["topology"] = topology
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_manifest(step_dir: str) -> Optional[Dict[str, Any]]:
    """Parsed manifest, or None when absent/undecodable (an unreadable
    manifest is indistinguishable from a missing one for the caller: the
    generation is unverifiable, not provably corrupt)."""
    path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("unreadable manifest %s: %s", path, e)
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("files"), dict):
        logger.warning("malformed manifest %s: not a {version, files} doc", path)
        return None
    return doc


def read_topology(step_dir: str) -> Optional[Dict[str, Any]]:
    """The topology document recorded at save time (mesh axis sizes, world
    size, jax versions — see ``resilience/elastic.py``), or None for
    pre-elastic checkpoints / unreadable manifests."""
    doc = read_manifest(step_dir)
    if doc is None:
        return None
    topo = doc.get("topology")
    return topo if isinstance(topo, dict) else None


def verify_manifest(step_dir: str, mode: str = "size") -> Optional[VerifyReport]:
    """Check ``step_dir`` against its manifest. Returns None when ``mode``
    is ``off`` or no (readable) manifest exists — "unverifiable" must stay
    distinguishable from "verified clean" AND from "provably corrupt" (a
    crash can land between payload commit and manifest write; condemning
    that healthy generation would turn the safety net into a data killer)."""
    if mode == "off":
        return None
    if mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; choose from {VERIFY_MODES}")
    doc = read_manifest(step_dir)
    if doc is None:
        return None
    if not doc["files"]:
        # topology-only manifest (written under ckpt_verify=off so the
        # generation stays diagnosable): no digests were recorded, so the
        # generation is UNVERIFIABLE — an empty file table must never read
        # as "verified clean"
        return None
    t0 = time.perf_counter()
    report = VerifyReport(root=step_dir, mode=mode, total=len(doc["files"]))
    for rel, meta in sorted(doc["files"].items()):
        full = os.path.join(step_dir, rel)
        want_size = int(meta.get("size", -1))
        try:
            if not os.path.isfile(full):
                report.problems.append(VerifyProblem(rel, "missing", "file absent"))
                continue
            have_size = os.path.getsize(full)
            if have_size != want_size:
                kind = "truncated" if have_size < want_size else "mismatch"
                report.problems.append(VerifyProblem(
                    rel, kind, f"size {have_size} != recorded {want_size}"
                ))
                continue
            if mode == "full":
                want_crc = str(meta.get("crc32", ""))
                have_crc, _ = crc32_file(full)
                if f"{have_crc:08x}" != want_crc:
                    report.problems.append(VerifyProblem(
                        rel, "mismatch",
                        f"crc32 {have_crc:08x} != recorded {want_crc}",
                    ))
        except OSError as e:
            # a file that passed isfile but can't be stat'd/read (ESTALE,
            # vanished mid-check) is unrestorable either way — classify it
            # rather than raise, so verify always yields ONE verdict (the
            # multi-process restore gate broadcasts it; an exception on one
            # rank would desync the collective)
            report.problems.append(VerifyProblem(rel, "missing", f"unreadable: {e}"))
    report.elapsed_s = time.perf_counter() - t0
    return report
