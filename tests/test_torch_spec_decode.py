"""Port speculative decoding (draft-then-verify) vs the JAX reference.

f32 on the CPU, on the reference's serving toys with the JAX weights carried
into the port (the harness of ``test_torch_serving.py``):

* Engine parity with ``spec_k`` 2 (and 4): the port's engine and the JAX one
  on the same streams (staggered loopy prompts that the ngram drafter hits,
  seeded sampling, a small pool that forces preemption, shared prefixes and
  copy-on-write replays with chunked prefill, the MoE toy, and an oracle
  drafter whose accepted draft is the eos token in the middle of a verify
  tick): the token events in order, token ids, finish reasons,
  ``cached_tokens``, ``spec_accepted_tokens``, the pool counts and the
  ``TRACE_COUNTS`` deltas (``paged_verify`` included) must be equal, and
  greedy requests must equal the port's ``greedy_generate``.
* The drafting, block-rollback, speculative-claim, admission-headroom and
  tracer assertions of ``tests/test_spec_decode.py``, replayed on the
  port's copies.
"""

import contextlib

import pytest

from veomni_tpu.ops.kernel_registry import KERNEL_REGISTRY as JAX_REGISTRY
from veomni_tpu_torch.models import decode as tdec
from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY
from veomni_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    KVBlockManager,
    PrefixCache,
    Request,
    Scheduler,
    SequenceState,
)
from veomni_tpu_torch.serving.spec_decode import draft_ngram, draft_off, resolve_draft_fn

from test_torch_serving import (  # noqa: F401 (_release_models: an autouse fixture)
    _greedy,
    _loopy_prompts,
    _release_models,
    _staggered,
    _system_prompts,
    assert_parity,
    models,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@contextlib.contextmanager
def registered_draft(name, fn):
    """A throwaway spec_draft impl in both registries for one test."""
    for reg in (KERNEL_REGISTRY, JAX_REGISTRY):
        reg.register("spec_draft", name)(fn)
    try:
        yield name
    finally:
        KERNEL_REGISTRY._ops["spec_draft"].pop(name, None)
        KERNEL_REGISTRY._resolve.cache_clear()
        JAX_REGISTRY._ops["spec_draft"].pop(name, None)
        JAX_REGISTRY.resolve.cache_clear()


def _sampled(i):
    return (_greedy(10) if i % 2 == 0
            else dict(max_new_tokens=10, temperature=0.8, top_k=10, top_p=0.9, seed=i))


SPEC_SCENARIOS = {
    "staggered_loopy": ("qwen3", dict(num_slots=2, block_size=8, max_model_len=96, spec_k=2),
                        lambda: _staggered(_loopy_prompts((21, 17, 25, 13), seed=7), 2, 2,
                                           lambda i: _greedy(10))),
    "k4_sampled": ("qwen3", dict(num_slots=3, block_size=8, max_model_len=96, spec_k=4),
                   lambda: _staggered(_loopy_prompts((21, 17, 25, 13), seed=8), 2, 3, _sampled)),
    "preemption": ("qwen3", dict(num_slots=3, block_size=8, max_model_len=48, num_blocks=9,
                                 spec_k=2),
                   lambda: [("submit", p, _greedy(12))
                            for p in _loopy_prompts((13, 15, 11), seed=1)] + [("drain",)]),
    "prefix_cow_chunked": (
        "qwen3", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8, spec_k=2),
        lambda: _staggered(_system_prompts(31, 16, (0, 5, 9)), 1, 3, lambda i: _greedy(8))
        + [("submit", _system_prompts(31, 16, (0,))[0], _greedy(8)), ("drain",)]),
    "moe": ("qwen3_moe", dict(num_slots=2, block_size=8, max_model_len=96, spec_k=2),
            lambda: _staggered(_loopy_prompts((19, 23, 14), seed=9), 2, 2, _sampled)),
}


@pytest.mark.parametrize("scenario", sorted(SPEC_SCENARIOS))
def test_spec_engine_matches_jax_engine(scenario):
    name, engine_kw, script = SPEC_SCENARIOS[scenario]
    events, outs, traces, stats = assert_parity(name, engine_kw, script())
    assert traces["paged_verify"] > 0 and stats["metrics"]["spec_proposed"] > 0
    if scenario == "preemption":
        assert stats["preemptions"] > 0
    if scenario == "prefix_cow_chunked":
        assert stats["cow"] >= 1


def test_spec_eos_mid_verify_matches_jax():
    """An oracle drafter proposes the true greedy continuation, so a verify
    tick accepts the eos token mid-tick: emission stops there in both
    engines, with the same events and accepted-token rollup."""
    _, _, model, cfg = models("qwen3")
    prompt = _loopy_prompts((17,), seed=9)[0]
    full = tdec.greedy_generate(model, cfg, prompt, max_new_tokens=8)[len(prompt):]
    eos = full[4]
    want = full[: full.index(eos) + 1]

    def oracle(context, k):
        g = len(context) - len(prompt)
        return full[g:g + k]

    with registered_draft("__test_oracle_eos", oracle) as name:
        _, outs, traces, _ = assert_parity("qwen3", dict(
            num_slots=2, block_size=8, max_model_len=64, spec_k=4, spec_draft=name,
        ), [("submit", prompt, dict(max_new_tokens=8, eos_id=eos)), ("drain",)])
    (out,) = outs.values()
    assert out[0] == want and out[1] == "eos"
    assert out[3] == len(want) - 2  # accepted drafts that landed as extra tokens
    assert traces["paged_verify"] > 0


def test_spec_enabled_honors_registry_pin():
    _, _, model, cfg = models("qwen3")
    ec = dict(num_slots=1, block_size=8, max_model_len=64)
    KERNEL_REGISTRY.pin("spec_draft", "off")
    try:
        eng = InferenceEngine(model, cfg, EngineConfig(spec_k=4, **ec), device="cpu")
        assert not eng._spec_enabled
        assert eng.scheduler.spec_headroom_blocks == 0
    finally:
        KERNEL_REGISTRY.clear_pins()
    KERNEL_REGISTRY.pin("spec_draft", "ngram")
    try:
        eng = InferenceEngine(model, cfg, EngineConfig(spec_k=4, spec_draft="off", **ec),
                              device="cpu")
        assert eng._spec_enabled and eng._draft_fn is draft_ngram
    finally:
        KERNEL_REGISTRY.clear_pins()


# ---------------------------------------------------------------------------
# The reference's host-side assertions (tests/test_spec_decode.py), replayed
# on the port's copies.
# ---------------------------------------------------------------------------
def test_draft_ngram_prompt_lookup():
    # tail [7,8] recurred earlier; the most recent occurrence is followed
    # by [9, 1] — that continuation is the proposal
    ctx = [1, 2, 7, 8, 3, 4, 7, 8, 9, 1, 5, 7, 8]
    assert draft_ngram(ctx, 4) == [9, 1, 5, 7]
    assert draft_ngram(ctx, 2) == [9, 1]  # k caps the proposal
    # no recurrence of any tail n-gram -> no proposal (slot degrades to 0)
    assert draft_ngram([1, 2, 3, 4, 5], 4) == []
    assert draft_ngram([1, 2], 0) == []
    assert draft_ngram([], 4) == []
    # the trivial strategy never proposes
    assert draft_off(ctx, 4) == []
    # a 1-token context can't have an earlier occurrence
    assert draft_ngram([5], 4) == []


def test_draft_ngram_prefers_longest_match():
    # the 2-gram tail [7, 8] matches at position 1 (-> 9 follows); the
    # 1-gram tail [8] ALSO matches at position 5 (-> 6 follows): the longer
    # n-gram wins because it is more specific
    ctx = [1, 7, 8, 9, 2, 8, 6, 7, 8]
    assert draft_ngram(ctx, 1) == [9]


def test_resolve_draft_fn_validates_and_honors_pin():
    assert resolve_draft_fn("ngram") is draft_ngram
    assert resolve_draft_fn("off") is draft_off
    with pytest.raises(ValueError, match="unknown spec_draft"):
        resolve_draft_fn("nope")
    # an ops-config pin outranks the engine knob (ulysses-dispatch rules)
    KERNEL_REGISTRY.pin("spec_draft", "off")
    try:
        assert resolve_draft_fn("ngram") is draft_off
    finally:
        KERNEL_REGISTRY.clear_pins()


def test_block_manager_shrink_rollback():
    bm = KVBlockManager(num_blocks=8, block_size=4)
    t = bm.allocate("a", 2)
    grown = bm.grow("a", 3)  # returns the full 5-entry table
    released = bm.shrink("a", 2)
    assert released == list(reversed(grown[2:]))  # tail first
    assert bm.table("a") == t
    assert bm.num_free == 5
    assert bm.shrink("a", 2) == []  # idempotent at the target
    assert bm.shrink("a", 99) == []  # never grows
    with pytest.raises(ValueError):
        bm.shrink("a", 0)  # a live sequence keeps >= 1 block
    with pytest.raises(KeyError, match="ghost"):
        bm.shrink("ghost", 1)


def test_block_manager_shrink_never_strands_shared_blocks():
    """A trailing block shared with another sequence (or cached) survives
    one sequence's rollback: shrink drops a REFERENCE, not the block."""
    bm = KVBlockManager(num_blocks=8, block_size=4)
    cache = PrefixCache(bm)
    t_a, _ = bm.allocate_shared("a", [], 3)
    t_b, _ = bm.allocate_shared("b", t_a, 0)  # b shares all of a's blocks
    released = bm.shrink("a", 1)
    assert released == [t_a[2], t_a[1]]
    # b still references them: NOT freed, refcount simply dropped to 1
    assert bm.refcount(t_a[1]) == 1 and bm.refcount(t_a[2]) == 1
    assert bm.num_free == 4  # nothing actually returned to the pool
    bm.free_seq("b")
    assert bm.num_free == 6  # now they are
    # cached (refcount-0-bound) trailing block: rollback re-enters it into
    # the evictable set via the cache, not the raw free list
    t_c, _ = bm.allocate_shared("c", [], 2)
    cache.insert(list(range(100, 108)), t_c)
    bm.shrink("c", 1)
    assert cache.has_block(t_c[1]) and cache.num_evictable() == 1
    assert bm.num_free_uncached + bm.num_cached == bm.num_free


def test_scheduler_claim_speculative_degrades_never_preempts():
    bm = KVBlockManager(num_blocks=6, block_size=4)  # 5 usable
    sched = Scheduler(2, bm)
    a = SequenceState(request=Request(prompt_ids=list(range(1, 9)),
                                      request_id="a"))
    b = SequenceState(request=Request(prompt_ids=list(range(1, 9)),
                                      request_id="b"))
    sched.add(a)
    sched.add(b)
    assert len(sched.admit()) == 2  # 2 blocks each, 1 free
    a.prefilling = b.prefilling = False
    a.pos = b.pos = 8
    # a wants 4 drafted positions = cover position 12 -> needs block 4, but
    # only ONE block is free: k degrades to what the claimed coverage holds
    k, claimed = sched.claim_speculative(a, 4)
    assert len(claimed) == 1 and k == 3  # coverage [0,12): pos 8 + 3 drafts
    assert bm.num_free == 0
    # the pool is dry: b's claim degrades all the way to 0 — NO preemption
    k_b, claimed_b = sched.claim_speculative(b, 4)
    assert (k_b, claimed_b) == (0, []) and sched.preemption_count == 0
    # rollback returns a's claim; b can then claim it
    bm.shrink("a", 2)
    assert sched.claim_speculative(b, 2)[0] > 0


def test_spec_admission_headroom_accounts_for_k_growth():
    """With speculation on, admission keeps ceil(spec_k/bs) extra blocks
    free per tick so a fresh admission doesn't starve every claim."""

    def build(spec_headroom):
        bm = KVBlockManager(num_blocks=8, block_size=4)  # 7 usable
        bm.allocate("x", 1)  # 6 free
        sched = Scheduler(2, bm, spec_headroom_blocks=spec_headroom)
        a = SequenceState(request=Request(prompt_ids=list(range(1, 9)),
                                          request_id="a"))
        b = SequenceState(request=Request(prompt_ids=list(range(1, 13)),
                                          request_id="b"))
        sched.add(a)
        sched.add(b)
        return bm, sched, a, b

    # WITHOUT spec headroom both admit in one pass: a (idle, no headroom,
    # 2 blocks), then b (3 blocks + 1 base headroom = 4 <= 4 free)
    _, sched0, a0, b0 = build(0)
    assert sched0.admit() == [a0, b0]
    # WITH one spec-headroom block b must wait: 3 + (1 + 1) = 5 > 4 free
    bm, sched, a, b = build(1)
    assert sched.admit() == [a]
    assert sched.admit() == []  # still head-of-line blocked on headroom
    bm.free_seq("x")  # one more free block covers the spec headroom
    assert sched.admit() == [b]


def test_tracer_tpot_uses_recorded_tick_counts():
    """Direct unit pin of the bugfix: when the per-tick counts disagree
    with ``tokens - 1`` (the old assumption of one token per decode tick),
    the recorded counts win."""
    from veomni_tpu_torch.observability.metrics import MetricsRegistry
    from veomni_tpu_torch.observability.request_trace import RequestTracer

    tracer = RequestTracer(1, registry=MetricsRegistry())
    tracer.on_queued("r")
    tracer.on_admitted("r", 0)
    tracer.on_first_token("r")
    # one verify tick emitted 4 tokens (3 accepted drafts + bonus)
    tracer.on_decode_tokens("r", 4, spec_accepted=3)
    tl = tracer.on_finished("r", "length", tokens=5)
    assert tl is not None and tl.tpot_s is not None
    wall = tl.finished_t - tl.first_token_t
    assert tl.tpot_s == pytest.approx(wall / 4)
    assert tl.spec_accepted_tokens == 3
    # fallback: an engine that never reports tick counts keeps the old
    # (tokens - 1) denominator
    tracer.on_queued("s")
    tracer.on_admitted("s", 0)
    tracer.on_first_token("s")
    tl2 = tracer.on_finished("s", "length", tokens=3)
    wall2 = tl2.finished_t - tl2.first_token_t
    assert tl2.tpot_s == pytest.approx(wall2 / 2)
