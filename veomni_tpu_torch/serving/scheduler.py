"""Continuous-batching scheduler: QoS admission, slot assignment, preemption.

Copy of ``veomni_tpu/serving/scheduler.py``.

Policy (vLLM-style recompute preemption, the QoS layer on top):

- **Per-class weighted admission**: waiting requests live in one arrival-
  ordered queue but are *picked* by QoS class. Each class (e.g.
  ``interactive``/``batch``, ``EngineConfig.classes``) owns a stride-
  scheduling pass value advanced by ``1/weight`` per admission, so a
  4:1-weighted interactive class gets ~4 of every 5 admissions while batch
  still progresses (no starvation in either direction — interactive can't
  starve behind a batch backlog, batch can't be frozen out). With a single
  configured class (or no classes) the pick degenerates to the queue head:
  **behavior-identical to the seed FIFO scheduler**.
- **Per-tenant fairness inside each class**: admission round-robins across
  tenants (deficit round robin with unit quantum: pick the waiting tenant
  with the lowest served count, newly active tenants joining at the current
  level so they can't burst on stale credit). One tenant flooding the queue
  cannot starve another's trickle; a single-tenant stream is plain FIFO.
- **Head-of-line within the pick**: the selected candidate is never admitted
  around — if its blocks don't fit, admission stops for this tick (out-of-
  order admission would make greedy outputs depend on pool pressure and
  break token-parity guarantees). Selection state (stride passes, tenant
  credits) commits only on successful admission.
- **Bounded queue + per-tenant in-flight caps (load-shedding)**: past
  ``queue_bound`` waiting requests (or ``tenant_max_inflight`` waiting+
  running for one tenant), :meth:`add` REFUSES the request (returns False —
  the engine turns that into a terminal ``rejected`` output, the
  429-equivalent) instead of growing the queue without bound. Preemption
  requeues are exempt: admitted work is never shed by its own recompute.
- **Prefix-cache-aware admission**: admission matches
  the recompute prompt against the radix tree and charges only the uncached
  suffix; a fully-covered prompt takes its divergence block copy-on-write.
- **Class-aware LIFO recompute preemption**: when a running sequence needs a
  block and the pool is dry (free list AND evictable cached blocks), the
  victim is the most recently admitted sequence of the LOWEST-priority
  class — batch preempts before interactive regardless of admission order;
  within a class, LIFO exactly as before. Victims requeue at the FRONT of
  the waiting order with ``prompt + generated-so-far`` as their recompute
  prompt; greedy decoding resumes the exact token stream.
- **Deadline expiry**: :meth:`expired` names waiting (and still-prefilling)
  sequences past their ``Request.deadline_s``; the engine cancels them via
  :meth:`cancel`, which releases any partially-claimed blocks AND a still-
  pinned copy-on-write source — a shed mid-chunked-prefill request can
  never leak pool blocks.

The scheduler is pure host bookkeeping — it owns no device state and is
unit-testable without building a model. Only the engine's pump thread
touches it (the exporter reads the thread-safe registry gauges the engine
publishes, never live scheduler state — docs/static-analysis.md). When a
:class:`~veomni_tpu_torch.observability.request_trace.RequestTracer` is attached
(the engine does), the scheduler reports its transitions — queued, admitted
(with slot), preempted — so every request carries a lifecycle timeline; the
engine reports the rest (prefill-done, first token, finished/cancelled).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from veomni_tpu_torch.serving.api import Request
from veomni_tpu_torch.serving.kv_block_manager import KVBlockManager

#: default QoS classes, highest priority first: interactive gets 4 of every
#: 5 admission picks under contention, batch the remaining 1
DEFAULT_CLASSES: Tuple[Tuple[str, int], ...] = (("interactive", 4),
                                                ("batch", 1))


def parse_classes(spec: Union[str, Sequence, None]
                  ) -> List[Tuple[str, int]]:
    """``"interactive:4,batch:1"`` (or an already-structured sequence of
    ``(name, weight)``) -> ordered class list, FIRST = highest priority
    (both for admission tie-breaks and for preemption: later classes are
    preempted first). Weights must be positive ints; names unique."""
    if spec is None or spec == "":
        return list(DEFAULT_CLASSES)
    if isinstance(spec, str):
        entries = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition(":")
            name = name.strip()
            if not name:
                raise ValueError(f"empty class name in classes spec {spec!r}")
            try:
                weight = int(w) if w.strip() else 1
            except ValueError:
                raise ValueError(
                    f"class weight must be an integer in {part!r} "
                    f"(classes spec {spec!r})"
                ) from None
            entries.append((name, weight))
    else:
        entries = [(str(n), int(w)) for n, w in spec]
    if not entries:
        raise ValueError(f"classes spec {spec!r} defines no classes")
    names = [n for n, _ in entries]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate class name in classes spec {spec!r}")
    for name, weight in entries:
        if weight < 1:
            raise ValueError(
                f"class {name!r} has non-positive weight {weight} "
                "(weights are admission shares, must be >= 1)"
            )
    return entries


class QoSPicker:
    """The QoS admission policy, factored out of :class:`Scheduler` so the
    scale-out router (``serving/router.py``) runs the IDENTICAL discipline
    over its own dispatch queue: per-class stride scheduling (pass values
    advance by ``1/weight`` per pick, a newly active class floored at the
    current virtual time so it can't burst on stale credit) with
    unit-quantum deficit-round-robin across each class's tenants.

    Items are duck-typed: anything carrying ``class_idx`` and ``tenant``
    attributes (the scheduler picks :class:`SequenceState`, the router its
    own queue entries). ``pick`` is pure — selection state commits in
    :meth:`commit` only once the caller actually takes the candidate, so a
    head-of-line wait never burns stride or tenant credit."""

    def __init__(self, classes: Optional[Sequence[Tuple[str, int]]] = None):
        # classes, highest priority first. None (or a single class) is the
        # seed FIFO policy: one queue, any priority label accepted.
        self.classes = list(classes) if classes else None
        self._weights = {i: w for i, (_, w) in enumerate(self.classes or ())}
        self._class_idx = {n: i for i, (n, _) in
                           enumerate(self.classes or ())}
        # stride-scheduling state across classes: pass values advance by
        # 1/weight per admission; _vtime floors a newly active class so an
        # idle class can't burst on stale credit
        self._pass: Dict[int, float] = {}
        self._vtime = 0.0
        # per-(class, tenant) served counts (unit-quantum DRR) + per-class
        # floor a newly active tenant joins at
        self._tenant_served: Dict[Tuple[int, str], int] = {}
        self._tenant_floor: Dict[int, int] = {}

    @property
    def single_class(self) -> bool:
        return self.classes is None or len(self.classes) == 1

    def resolve_class(self, priority: str) -> int:
        """Class index for a request's priority label. A single-class (or
        class-less) picker accepts ANY label into its one queue — the
        seed-FIFO configuration; a multi-class one refuses unknown labels
        loudly (a typo'd priority silently landing in the wrong tier would
        be an SLO bug nobody can see)."""
        if self.single_class:
            return 0
        try:
            return self._class_idx[priority]
        except KeyError:
            raise ValueError(
                f"unknown priority class {priority!r}; configured classes: "
                f"{[n for n, _ in self.classes]}"
            ) from None

    def pick(self, waiting: Sequence[Any]) -> Optional[Any]:
        """Next candidate from ``waiting`` (arrival order, front first)
        under the QoS policy. Pure — commit separately."""
        if not waiting:
            return None
        if self.single_class:
            return waiting[0]  # seed FIFO exactly
        # stride pick across active classes: lowest effective pass wins,
        # ties break toward the higher-priority (earlier) class. An idle
        # class's stale pass is floored at _vtime so it can't burst.
        active = sorted({s.class_idx for s in waiting})
        c = min(active, key=lambda i: (max(self._pass.get(i, 0.0),
                                           self._vtime), i))
        # unit-quantum DRR across the class's active tenants: lowest served
        # count wins, ties break toward the earliest-waiting tenant
        order: List[str] = []
        for s in waiting:
            if s.class_idx == c and s.tenant not in order:
                order.append(s.tenant)
        t = min(order, key=lambda tn: (
            max(self._tenant_served.get((c, tn), 0),
                self._tenant_floor.get(c, 0)),
            order.index(tn),
        ))
        for s in waiting:
            if s.class_idx == c and s.tenant == t:
                return s
        raise AssertionError("picked (class, tenant) has no waiting seq")

    def commit(self, item: Any) -> None:
        """Charge the taken candidate's class stride + tenant credit (the
        caller removes it from its own waiting order)."""
        if self.single_class:
            return
        c = item.class_idx
        base = max(self._pass.get(c, 0.0), self._vtime)
        self._vtime = base
        self._pass[c] = base + 1.0 / self._weights[c]
        served = max(self._tenant_served.get((c, item.tenant), 0),
                     self._tenant_floor.get(c, 0))
        self._tenant_served[(c, item.tenant)] = served + 1
        # newly active tenants join at the level of the last pick: fair
        # from now on, no retroactive catch-up burst
        self._tenant_floor[c] = served

    def prune_tenant(self, tenant: str) -> None:
        """Drop a fully-drained tenant's DRR credit entries: a long-running
        server sees unboundedly many distinct tenant ids, and keeping one
        counter per (class, tenant) forever would leak. Safe for fairness —
        a rejoining tenant is re-floored at the class's current credit
        level (``max(served, _tenant_floor[c])``), exactly as if its stale
        entry had been kept. The caller checks the tenant really is
        drained (no waiting or running work) before calling."""
        for key in [k for k in self._tenant_served if k[1] == tenant]:
            del self._tenant_served[key]


@dataclass
class SequenceState:
    """Host-side runtime state of one request (survives preemption)."""

    request: Request
    generated: List[int] = field(default_factory=list)  # ALL emitted tokens
    rng: Any = None  # per-request PRNG key carry [2] uint32
    slot: int = -1
    pos: int = 0  # write position of the pending last token
    prefill_len: int = 0  # positions covered by the latest prefill
    admit_order: int = -1
    preemptions: int = 0
    submit_time: float = field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    # QoS class index into the scheduler's class list (0 with classes off)
    class_idx: int = 0
    # chunked-prefill / prefix-cache state for the CURRENT admission
    prefilling: bool = False  # admitted, prefill not finished (chunks left)
    prefill_pos: int = 0  # next uncomputed position (rows [0, here) valid)
    cached_tokens: int = 0  # positions served from the prefix cache
    cow_src: Optional[int] = None  # pinned copy-on-write source block

    @property
    def seq_id(self) -> str:
        return self.request.request_id

    @property
    def tenant(self) -> str:
        return getattr(self.request, "tenant", "")

    @property
    def deadline_s(self) -> Optional[float]:
        return getattr(self.request, "deadline_s", None)

    def deadline_expired(self, now: float) -> bool:
        dl = self.deadline_s
        return dl is not None and (now - self.submit_time) > dl

    @property
    def recompute_prompt(self) -> List[int]:
        """What a (re)admission must prefill: the original prompt plus every
        token generated before preemption."""
        return list(self.request.prompt_ids) + list(self.generated)

    @property
    def last_token(self) -> int:
        return self.generated[-1]

    @property
    def kv_valid_len(self) -> int:
        """Cache rows [0, here) hold real KV: up to the write position when
        decoding, up to the last completed chunk while mid-prefill."""
        return self.prefill_pos if self.prefilling else self.pos


class Scheduler:
    def __init__(self, num_slots: int, block_manager: KVBlockManager,
                 tracer: Optional[Any] = None,
                 prefix_cache: Optional[Any] = None,
                 spec_headroom_blocks: int = 0,
                 classes: Optional[Sequence[Tuple[str, int]]] = None,
                 queue_bound: int = 0,
                 tenant_max_inflight: int = 0):
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        if queue_bound < 0:
            raise ValueError("queue_bound must be >= 0 (0 = unbounded)")
        if tenant_max_inflight < 0:
            raise ValueError("tenant_max_inflight must be >= 0 (0 = uncapped)")
        self.blocks = block_manager
        self.cache = prefix_cache
        # arrival-ordered waiting list (front = next within its class and
        # tenant; preemption requeues at the very front). The QoS pick
        # selects INTO this order — it never reorders it, so within one
        # (class, tenant) stream admission is exactly the seed FIFO.
        self._waiting: List[SequenceState] = []
        self.slots: List[Optional[SequenceState]] = [None] * num_slots
        self.preemption_count = 0
        self._admit_counter = 0
        # optional RequestTracer (duck-typed: anything with on_queued /
        # on_admitted / on_preempted) — None keeps the scheduler trace-free
        self.tracer = tracer
        # QoS classes, highest priority first. None (or a single class) is
        # the seed scheduler: one FIFO queue, any priority label admitted.
        # The stride/DRR policy itself lives in QoSPicker so the scale-out
        # router shares the one implementation.
        self.qos = QoSPicker(classes)
        self.classes = self.qos.classes
        # admission control: 0 disables either bound (seed behavior)
        self.queue_bound = queue_bound
        self.tenant_max_inflight = tenant_max_inflight
        # extra admission headroom when the engine decodes speculatively:
        # a running sequence can grow by ceil(spec_k / block_size) blocks
        # per tick on top of the usual one, so admission keeps that many
        # more blocks free per tick — a fresh admission must not force every
        # speculative claim to degrade to k=0 on its very first step. 0
        # (the default, spec off) keeps the seed admission policy exactly.
        self.spec_headroom_blocks = spec_headroom_blocks

    # ---------------------------------------------------------------- queries
    @property
    def waiting(self) -> List["SequenceState"]:
        """Waiting sequences in arrival order (requeued preemptions at the
        front) — a read-only view for tests/introspection; the QoS pick
        decides the actual admission order."""
        return list(self._waiting)

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        return bool(self._waiting) or self.num_running > 0

    def running(self) -> List[Tuple[int, SequenceState]]:
        """(slot, seq) pairs in slot order — the decode batch row order."""
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def resolve_class(self, priority: str) -> int:
        """Class index for a request's priority label (delegates to the
        shared :class:`QoSPicker`: single-class accepts any label — the
        seed-FIFO configuration — multi-class refuses unknown ones)."""
        return self.qos.resolve_class(priority)

    def tenant_inflight(self, tenant: str) -> int:
        """Waiting + running sequences charged to one tenant (the in-flight
        cap's accounting unit)."""
        n = sum(1 for s in self._waiting if s.tenant == tenant)
        n += sum(1 for _, s in self.running() if s.tenant == tenant)
        return n

    # ------------------------------------------------------------ transitions
    def add(self, seq: SequenceState) -> bool:
        """Enqueue a fresh request. Returns False — the load-shedding
        refusal, the engine's 429-equivalent — when the waiting queue is at
        ``queue_bound`` or the sequence's tenant is at
        ``tenant_max_inflight``; the caller owns turning that into a
        terminal REJECTED output. Accepted sequences get their class index
        resolved here (unknown labels raise, see :meth:`resolve_class`)."""
        seq.class_idx = self.resolve_class(
            getattr(seq.request, "priority", "interactive")
        )
        if self.queue_bound and len(self._waiting) >= self.queue_bound:
            return False
        if self.tenant_max_inflight and (
                self.tenant_inflight(seq.tenant) >= self.tenant_max_inflight):
            return False
        self._waiting.append(seq)
        if self.tracer is not None:
            self.tracer.on_queued(seq.seq_id)
        return True

    # ------------------------------------------------------------- QoS pick
    def _pick_candidate(self) -> Optional[SequenceState]:
        """Next admission candidate under the QoS policy (the shared
        :class:`QoSPicker`). Pure — selection state commits in
        :meth:`_commit_pick` only after the candidate's blocks actually
        fit, so a head-of-line wait doesn't burn credit."""
        return self.qos.pick(self._waiting)

    def _commit_pick(self, seq: SequenceState) -> None:
        """Remove the admitted candidate from the waiting order and charge
        its class stride + tenant credit."""
        self._waiting.remove(seq)
        self.qos.commit(seq)

    def admit(self) -> List[SequenceState]:
        """Fill free slots from the waiting queue (QoS pick; plain FIFO
        head-of-line with a single class). Admission matches the recompute
        prompt against the prefix cache, shares the matched blocks, and
        allocates only the uncached suffix — plus one extra free block of
        headroom so a fresh admission isn't preempted on its very first
        decode step just to grow someone else. The picked candidate is
        never admitted around: if it doesn't fit, admission stops."""
        admitted = []
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self._waiting:
                continue
            head = self._pick_candidate()
            prompt = head.recompute_prompt
            p = len(prompt)
            n_total = self.blocks.blocks_for(p)
            shared: List[int] = []
            cow_src: Optional[int] = None
            if self.cache is not None:
                shared = self.cache.match(prompt)
                if len(shared) * self.blocks.block_size >= p:
                    # every full block is cached, but the engine still needs
                    # the LAST token's logits to sample the first generated
                    # token: recompute only that token, copy-on-write its
                    # (shared, otherwise-corrupted) divergence block
                    cow_src = shared[-1]
                    shared = shared[:-1]
            n_new = n_total - len(shared)
            # no headroom demanded when the engine is idle: an exact-fit
            # request must admit (it can still grow — the engine validates
            # blocks_for(prompt+max_new) <= pool size at submit). With
            # speculative decoding on, per-tick growth is up to
            # spec_headroom_blocks MORE than the one-token step's single
            # block (k drafted positions per running sequence).
            headroom = ((1 + self.spec_headroom_blocks) if self.num_running
                        else 0)
            # matched blocks currently sitting in the evictable set leave it
            # the moment allocate_shared references them, so they must not
            # double-count as claimable headroom
            pinned = [b for b in shared if self.blocks.refcount(b) == 0]
            if cow_src is not None and self.blocks.refcount(cow_src) == 0:
                pinned.append(cow_src)
            if self.blocks.num_free - len(pinned) < n_new + headroom:
                break  # head-of-line: never admit around the picked head
            self._commit_pick(head)
            self.blocks.allocate_shared(head.seq_id, shared, n_new,
                                        cow_src=cow_src)
            head.cow_src = cow_src
            head.cached_tokens = (
                p - 1 if cow_src is not None
                else len(shared) * self.blocks.block_size
            )
            head.prefill_pos = head.cached_tokens
            head.prefilling = True
            head.slot = slot
            head.admit_order = self._admit_counter
            self._admit_counter += 1
            self.slots[slot] = head
            admitted.append(head)
            if self.tracer is not None:
                self.tracer.on_admitted(head.seq_id, slot)
        return admitted

    def _preempt_victim(self) -> SequenceState:
        """Class-aware LIFO: the newest admission of the LOWEST-priority
        running class — batch is evicted before interactive no matter who
        arrived first; within one class this is exactly the seed LIFO."""
        return max((s for _, s in self.running()),
                   key=lambda s: (s.class_idx, s.admit_order))

    def ensure_decode_capacity(self) -> List[SequenceState]:
        """Grow each decoding sequence to cover its next write position,
        preempting (class-aware LIFO) when the pool — free list plus
        evictable cached blocks — runs dry. Mid-prefill sequences already
        hold their whole prompt allocation and are skipped for growth (but
        stay preemptable). Returns the preempted sequences (already
        requeued at the front of the waiting queue)."""
        preempted: List[SequenceState] = []
        for _, seq in self.running():
            if seq.slot < 0 or seq.prefilling:  # preempted / still prefilling
                continue
            need = seq.pos // self.blocks.block_size + 1
            while self.blocks.num_allocated(seq.seq_id) < need:
                if self.blocks.can_allocate(1):
                    self.blocks.grow(seq.seq_id, 1)
                    continue
                victim = self._preempt_victim()
                self._preempt(victim)
                preempted.append(victim)
                if victim is seq:
                    break
        return preempted

    def claim_speculative(self, seq: SequenceState,
                          k: int) -> Tuple[int, List[int]]:
        """Best-effort block claim for ``k`` drafted positions beyond the
        sequence's pending write position: grow its table until positions
        [pos, pos + k] are covered or the pool runs dry. NEVER preempts —
        speculation is an optimization, so a dry pool degrades k (possibly
        to 0, a pure decode step) instead of evicting a running sequence.
        Cached refcount-0 blocks still count as claimable (the pool's
        ``free ∪ evictable`` accounting), exactly like any other growth.

        Returns ``(k_granted, claimed_blocks)``: the draft length the
        claimed coverage supports, and the freshly claimed block ids — the
        engine rolls the unaccepted suffix back via
        :meth:`KVBlockManager.shrink` after the verify step."""
        bs = self.blocks.block_size
        have = self.blocks.num_allocated(seq.seq_id)
        need = (seq.pos + k) // bs + 1
        claimed: List[int] = []
        while have < need and self.blocks.can_allocate(1):
            claimed.append(self.blocks.grow(seq.seq_id, 1)[-1])
            have += 1
        # coverage reached: positions [0, have*bs) — the last draftable
        # position is have*bs - 1, so k_granted drafts fit after pos (a
        # pool so dry the PENDING position isn't even covered grants 0;
        # the mandatory ensure_decode_capacity pass handles that case)
        return max(0, min(k, have * bs - 1 - seq.pos)), claimed

    def expired(self, now: Optional[float] = None) -> List[SequenceState]:
        """Sequences past their deadline that have produced NOTHING yet:
        still waiting for their first admission, or admitted but still
        mid-initial-prefill. A sequence that has emitted tokens keeps
        running to completion no matter where it sits — including a
        preempted one waiting to re-admit: cancelling a partially-streamed
        request mid-stream would waste the delivered tokens AND make the
        client-visible outcome depend on pool pressure (whether a
        preemption happened to land), exactly the coupling the head-of-line
        admission rule exists to prevent. Late finishers are merely marked
        deadline_missed and excluded from goodput. The engine cancels each
        returned sequence via :meth:`cancel`."""
        if now is None:
            now = time.perf_counter()
        out = [s for s in self._waiting
               if not s.generated and s.deadline_expired(now)]
        out += [s for _, s in self.running()
                if s.prefilling and not s.generated
                and s.deadline_expired(now)]
        return out

    def cache_insert(self, seq: SequenceState) -> int:
        """Register the sequence's full KV blocks in the prefix cache, keyed
        on the tokens they hold. Called at prefill completion (prompt blocks
        become shareable immediately) and before releasing blocks on
        preemption/finish (generated-token blocks stay warm)."""
        if self.cache is None or self.blocks.num_allocated(seq.seq_id) == 0:
            return 0
        n_full = seq.kv_valid_len // self.blocks.block_size
        if n_full <= 0:
            return 0
        tokens = seq.recompute_prompt
        table = self.blocks.table(seq.seq_id)
        return self.cache.insert(tokens[: n_full * self.blocks.block_size],
                                 table[:n_full])

    def _release(self, seq: SequenceState) -> None:
        """Drop the sequence's block references, caching its full blocks
        first so they stay warm for re-admission or other requests. A
        still-pinned copy-on-write source (admission happened but the
        engine's device copy hasn't landed — possible when a sequence is
        cancelled between the two) releases here too: the shed-mid-prefill
        path must leak NOTHING."""
        self.cache_insert(seq)
        self.blocks.free_seq(seq.seq_id)
        if seq.cow_src is not None:
            self.blocks.release_block(seq.cow_src)
            seq.cow_src = None

    def _preempt(self, seq: SequenceState) -> None:
        self._release(seq)
        self.slots[seq.slot] = None
        seq.slot = -1
        seq.preemptions += 1
        self.preemption_count += 1
        # reset per-admission prefill state: the next admit() re-matches the
        # (longer) recompute prompt against the cache from scratch
        seq.prefilling = False
        seq.prefill_pos = 0
        seq.cached_tokens = 0
        seq.pos = 0
        # requeue at the FRONT, bypassing the admission-control bounds:
        # admitted work is never shed by its own recompute
        self._waiting.insert(0, seq)
        if self.tracer is not None:
            self.tracer.on_preempted(seq.seq_id)

    def cancel(self, seq: SequenceState) -> None:
        """Remove a sequence wherever it is — waiting (deadline expiry,
        explicit cancel) or running (shed mid-chunked-prefill) — releasing
        every block reference it holds, including partially-claimed prefill
        blocks and a pinned copy-on-write source. Idempotent."""
        if seq.slot >= 0:
            self._release(seq)
            self.slots[seq.slot] = None
            seq.slot = -1
        else:
            try:
                self._waiting.remove(seq)
            except ValueError:
                pass  # already admitted/cancelled — nothing to remove
        self._prune_tenant(seq.tenant)

    def finish(self, seq: SequenceState) -> None:
        self._release(seq)
        if seq.slot >= 0:
            self.slots[seq.slot] = None
        seq.slot = -1
        self._prune_tenant(seq.tenant)

    def _prune_tenant(self, tenant: str) -> None:
        """Drop a fully-drained tenant's DRR credit entries (the leak
        guard lives in :class:`QoSPicker`; the drained check — no waiting
        or running work left — is the scheduler's)."""
        if any(s.tenant == tenant for s in self._waiting):
            return
        if any(s.tenant == tenant for _, s in self.running()):
            return
        self.qos.prune_tenant(tenant)
