"""Deterministic fault injection: named fault points armed from a JSON plan.

The recovery machinery (retry, rollback, watchdog, graceful shutdown) is only
trustworthy if every path can be *driven* deterministically on CPU in tier-1 —
real preemptions and flaky filesystems don't show up on demand. A fault plan
names a point, a 1-based hit index, and an action; the instrumented sites call
``fault_point(name)`` which is a no-op (one ``is None`` check) when unarmed.

Fault points wired through the stack:

==============  ==============================================================
``ckpt.save``   inside the checkpointer's per-attempt save dispatch (retried)
``ckpt.restore``inside the checkpointer's per-attempt restore (retried)
``ckpt.manifest`` right after rank 0 writes a committed generation's
                integrity manifest (context: the step dir) — the ``corrupt``
                drill point for storage rot on checkpoint payloads
``ckpt.reshard`` inside each elastic sidecar merge/split attempt (reading
                every saved rank's ``extra_state_rank*.json`` and deriving
                this rank's cursor on the new world size; retried, fires per
                attempt) — drills the topology-change restore path
``data.fetch``  streaming shard record reads (retried, fires per attempt)
                AND the prefetch worker's per-batch pull (NOT retried: an
                exception there exercises the worker->consumer error
                transport and fails the run fast). With streaming+prefetch
                both active the two sites share one hit counter.
``data.record`` per streaming record read, BEFORE decode (context: the shard
                file) — the ``corrupt`` drill point for poisoned data records
``step.loss``   host-side observation of the train step's finite-loss flag
``step.params`` once per trainer-loop iteration, before dispatch — ``nan``
                mode plants a REAL NaN in one element of the first float
                param leaf whose dotted path contains the spec's ``group``
                (the numerics observatory's provenance drill: the following
                step genuinely blows up on device and the attribution
                machinery must find and name the poisoned group)
``step.delay``  once per trainer-loop iteration, host side, before dispatch —
                the ``delay`` drill point: a straggler (one rank slower than
                the fleet) is injected deterministically so the fleet
                observatory's skew detection runs under JAX_PLATFORMS=cpu in
                tier-1 like every other recovery path
``serve.admit`` per ``InferenceEngine.submit()`` call, before intake
                validation — drills the serving front door (an
                ``exception`` here is a failed admission the client sees;
                ``delay`` models a slow intake path)
``serve.prefill`` per prefill tick (one sequence advancing one chunk), host
                side, before the jitted chunk dispatch — drills slow/failed
                prefill under load (TTFT degradation, mid-prefill
                cancellation windows)
``serve.decode_tick`` per batched decode tick, host side, before the jitted
                step dispatch — the serving straggler/stall drill: ``delay``
                makes every running request's TPOT degrade together,
                ``hang`` drives the watchdog/flight-recorder post-mortem
                path deterministically on CPU (mirrors what ``step.loss``
                hangs do for the trainer)
``serve.spawn`` per router replica (re)spawn, before the engine is built —
                drills the self-healing fleet's resurrection path
                (``exception`` burns a ``max_respawns`` budget attempt and
                reschedules the backoff; hitting it repeatedly drives the
                lineage into permanent retirement)
``serve.publish`` per replica weight hot-swap (context: the rid), on the
                router thread, after the replica drained but BEFORE its
                engine buffers are touched — the kill-mid-publish drill: an
                ``exception`` kills the replica mid-publish (normal failure
                triage; its respawn attaches at the LATEST version),
                ``delay`` widens the mixed-version window. Runs on the
                router thread like ``serve.admit``, so ``hang`` would stall
                the whole front door — use exception/delay here
==============  ==============================================================

Plan grammar (``VEOMNI_FAULT_PLAN`` holds the JSON text, or ``@/path/to.json``):

.. code-block:: json

    [{"point": "ckpt.save", "mode": "exception", "hit": 2, "times": 3},
     {"point": "step.loss", "mode": "nan", "hit": 4},
     {"point": "data.fetch", "mode": "hang", "hit": 1, "seconds": 2.0},
     {"point": "ckpt.manifest", "mode": "corrupt", "hit": 4, "op": "bitflip"}]

* ``point``   (required) fault-point name;
* ``mode``    ``exception`` (default; raises :class:`InjectedFault`, an
  ``OSError`` so the retry layer treats it as I/O), ``nan`` (returns a
  :class:`FaultAction` the site applies — poisons the observed loss signal),
  ``hang`` (sleeps ``seconds`` — bounded, so a watchdog test can't wedge CI),
  ``delay`` (sleeps ``ms`` milliseconds then returns normally — a
  deterministic *slowdown*, not a stall: the straggler-drill primitive, with
  the same hit/times windowing as every other mode),
  ``corrupt`` (damages a file ON DISK — deterministic truncate-or-bitflip —
  then returns normally: the *later* read of those bytes is what fails, like
  real storage rot);
* ``hit``     1-based hit index at which the fault starts firing (default 1);
* ``times``   consecutive hits that fire from ``hit`` on (default 1);
* ``seconds`` hang duration (default 30);
* ``ms``      delay duration in milliseconds (default 50);
* ``message`` exception text override;
* ``op``      corrupt only: ``bitflip`` (default; XOR 0xFF one byte in place
  — same size, only a ``full`` digest verify catches it) or ``truncate``
  (cut the file short — a ``size`` verify catches it);
* ``file``    corrupt only: the target, resolved against the site's context
  dir (glob allowed, first sorted match). Default: the LARGEST file under
  the context dir (for a checkpoint dir that is the array payload), or the
  context file itself when the site names one;
* ``offset``  corrupt/bitflip only: byte offset to flip (default -1 = the
  middle byte — deterministic, and never the final partial page a truncate
  test would also catch);
* ``group``   ``step.params``/nan only: dotted-path substring selecting the
  param leaf to poison (empty = first float leaf in sorted-path order).

Hit counters are per point and shared across specs targeting the same point,
so "fail hits 2-4" composes with "hang hit 7" on one point deterministically.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_PLAN = "VEOMNI_FAULT_PLAN"

KNOWN_POINTS = ("ckpt.save", "ckpt.restore", "ckpt.manifest", "ckpt.reshard",
                "data.fetch", "data.record", "step.loss", "step.delay",
                "step.params", "serve.admit", "serve.prefill",
                "serve.decode_tick", "serve.spawn", "serve.publish")

_MODES = ("exception", "nan", "hang", "delay", "corrupt")

_CORRUPT_OPS = ("bitflip", "truncate")


class InjectedFault(OSError):
    """Raised by an armed ``exception``-mode fault point.

    Subclasses ``OSError`` so the retry layer's default I/O classification
    covers it — the injected failure exercises exactly the real-I/O path.
    """


@dataclass
class FaultAction:
    """What an armed fault point decided for this hit (returned for modes the
    call site must apply itself, i.e. ``nan``; ``corrupt`` actions carry the
    damaged path for test assertions)."""

    point: str
    mode: str
    hit: int
    target: str = ""


@dataclass
class _FaultSpec:
    point: str
    mode: str = "exception"
    hit: int = 1
    times: int = 1
    seconds: float = 30.0
    ms: float = 50.0
    message: str = ""
    op: str = "bitflip"
    file: str = ""
    offset: int = -1
    group: str = ""

    def covers(self, hit: int) -> bool:
        return self.hit <= hit < self.hit + self.times


@dataclass
class _FaultPlan:
    specs: List[_FaultSpec]
    hits: Dict[str, int] = field(default_factory=dict)
    fired: List[FaultAction] = field(default_factory=list)


_PLAN: Optional[_FaultPlan] = None


def _parse_specs(raw: Any) -> List[_FaultSpec]:
    if isinstance(raw, dict):  # {"plan": [...]} wrapper tolerated
        raw = raw.get("plan", [])
    if not isinstance(raw, list):
        raise ValueError(f"fault plan must be a JSON list, got {type(raw).__name__}")
    specs = []
    for entry in raw:
        if not isinstance(entry, dict):
            raise ValueError(f"fault-plan entry must be an object: {entry!r}")
        point = entry.get("point")
        if not point:
            raise ValueError(f"fault-plan entry missing 'point': {entry!r}")
        mode = entry.get("mode", "exception")
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; choose from {_MODES}")
        if mode == "nan" and point not in ("step.loss", "step.params"):
            # only the supervisor's step.loss observation (poisons the
            # OBSERVED flag) and the trainer's step.params site (plants a
            # REAL NaN in one param leaf — the numerics-provenance drill)
            # interpret "nan"; anywhere else the returned action is
            # ignored, yet it would log "fault injected" — a drill that
            # believes it tested something
            raise ValueError(
                f"mode 'nan' only applies to points 'step.loss'/"
                f"'step.params', not {point!r}"
            )
        op = entry.get("op", "bitflip")
        if op not in _CORRUPT_OPS:
            raise ValueError(
                f"unknown corrupt op {op!r}; choose from {_CORRUPT_OPS}"
            )
        if point not in KNOWN_POINTS:
            # warn, don't reject (plans may target points added later) — but
            # a typo'd name would otherwise arm a drill that tests nothing
            logger.warning_rank0(
                "fault plan targets unknown point %r (known: %s) — it will "
                "never fire unless code calls fault_point(%r)",
                point, ", ".join(KNOWN_POINTS), point,
            )
        specs.append(_FaultSpec(
            point=point, mode=mode,
            hit=int(entry.get("hit", 1)),
            times=int(entry.get("times", 1)),
            seconds=float(entry.get("seconds", 30.0)),
            ms=float(entry.get("ms", 50.0)),
            message=str(entry.get("message", "")),
            op=op,
            file=str(entry.get("file", "")),
            offset=int(entry.get("offset", -1)),
            group=str(entry.get("group", "")),
        ))
    return specs


def configure_faults(plan: Any) -> None:
    """Arm a plan programmatically (tests); ``plan`` is the parsed-JSON list
    (or ``{"plan": [...]}``), or a JSON string."""
    global _PLAN
    if isinstance(plan, str):
        plan = json.loads(plan)
    specs = _parse_specs(plan)
    _PLAN = _FaultPlan(specs=specs) if specs else None
    if _PLAN is not None:
        logger.warning_rank0(
            "FAULT INJECTION ARMED: %d spec(s) across points %s",
            len(specs), sorted({s.point for s in specs}),
        )


def arm_from_env() -> bool:
    """Arm from ``VEOMNI_FAULT_PLAN`` (JSON text or ``@file``). Returns True
    if a plan was armed. Called by the trainer at train start and by the
    checkpointer/data layers lazily via :func:`fault_point` staying unarmed."""
    raw = os.environ.get(ENV_PLAN, "")
    if not raw:
        return False
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    configure_faults(json.loads(raw))
    return _PLAN is not None


def disarm_faults() -> None:
    global _PLAN
    _PLAN = None


def fired_faults() -> List[FaultAction]:
    """History of fired actions (telemetry/assertions); empty when unarmed."""
    return list(_PLAN.fired) if _PLAN is not None else []


def _resolve_corrupt_target(spec: _FaultSpec,
                            context: Optional[Dict[str, str]]) -> Optional[str]:
    """The file a ``corrupt`` spec damages. Explicit ``spec.file`` resolves
    against the site's context dir (glob allowed, first sorted match);
    otherwise the context's named file, or the LARGEST file under the
    context dir — for a checkpoint generation that is the array payload,
    which is exactly what real storage rot statistically hits."""
    ctx = context or {}
    base = ctx.get("dir") or (
        os.path.dirname(ctx["file"]) if ctx.get("file") else ""
    )
    if spec.file:
        if not os.path.isabs(spec.file) and not base:
            # a relative pattern at a context-less point would glob the
            # process CWD and damage an unrelated file; refuse (the caller
            # warns that the drill corrupted nothing)
            return None
        pattern = spec.file if os.path.isabs(spec.file) else os.path.join(
            base, spec.file
        )
        import glob as _glob

        matches = sorted(
            p for p in _glob.glob(pattern, recursive=True) if os.path.isfile(p)
        )
        return matches[0] if matches else None
    if ctx.get("file"):
        return ctx["file"] if os.path.isfile(ctx["file"]) else None
    if base:
        best, best_size = None, -1
        for dirpath, _dirs, files in sorted(os.walk(base)):
            for fname in sorted(files):
                full = os.path.join(dirpath, fname)
                try:
                    size = os.path.getsize(full)
                except OSError:
                    continue
                if size > best_size:
                    best, best_size = full, size
        return best
    return None


def _apply_corruption(spec: _FaultSpec, target: str) -> None:
    size = os.path.getsize(target)
    if spec.op == "truncate":
        new_size = max(0, size // 2)
        with open(target, "r+b") as f:
            f.truncate(new_size)
        logger.warning_rank0(
            "fault corrupted %s: truncated %d -> %d bytes", target, size, new_size
        )
    else:  # bitflip: same size, so only a full digest verify can see it
        if size == 0:
            logger.warning_rank0("fault corrupt target %s is empty; no-op", target)
            return
        off = spec.offset if 0 <= spec.offset < size else size // 2
        with open(target, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0xFF]))
        logger.warning_rank0(
            "fault corrupted %s: flipped byte at offset %d of %d", target, off, size
        )


def fault_point(name: str,
                context: Optional[Dict[str, str]] = None) -> Optional[FaultAction]:
    """Instrumentation hook. Unarmed: one None-check, zero overhead.

    Armed: bumps the point's hit counter; if a spec covers this hit, applies
    the action — ``exception`` raises :class:`InjectedFault`, ``hang`` sleeps
    (bounded) then returns the action, ``delay`` sleeps ``ms`` milliseconds
    (a deterministic slowdown for straggler drills) then returns the action,
    ``nan`` returns the action for the call site to apply, ``corrupt``
    damages the resolved file on disk and
    returns (the later READ of those bytes is the failure, like real rot).
    ``context`` is site-supplied corruption scope: ``{"dir": step_dir}`` or
    ``{"file": shard_path}``. Returns None when nothing fired.
    """
    plan = _PLAN
    if plan is None:
        return None
    hit = plan.hits.get(name, 0) + 1
    plan.hits[name] = hit
    for spec in plan.specs:
        if spec.point != name or not spec.covers(hit):
            continue
        action = FaultAction(point=name, mode=spec.mode, hit=hit)
        if spec.mode == "nan" and spec.group:
            # step.params: the target param-group substring rides on the
            # action for the trainer's poison site
            action.target = spec.group
        if spec.mode == "corrupt":
            target = _resolve_corrupt_target(spec, context)
            if target is None:
                logger.warning_rank0(
                    "corrupt fault at %s (hit %d) resolved NO target file "
                    "(context=%r, file=%r) — drill corrupted nothing",
                    name, hit, context, spec.file,
                )
                continue
            action.target = target
        plan.fired.append(action)
        logger.warning_rank0(
            "fault injected: point=%s mode=%s hit=%d", name, spec.mode, hit
        )
        # chaos drills must be legible in a post-mortem: an injected fault
        # that later kills the run should never read as organic rot
        from veomni_tpu_torch.observability.flight_recorder import record

        record("fault.injected", cid=name, mode=spec.mode, hit=hit)
        if spec.mode == "exception":
            raise InjectedFault(
                spec.message or f"injected fault at {name} (hit {hit})"
            )
        if spec.mode == "hang":
            time.sleep(spec.seconds)
        if spec.mode == "delay":
            time.sleep(spec.ms / 1000.0)
        if spec.mode == "corrupt":
            _apply_corruption(spec, action.target)
        return action
    return None
