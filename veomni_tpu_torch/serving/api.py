"""Request/response surface of the continuous-batching inference engine.

Copy of ``veomni_tpu/serving/api.py``.

Plain dataclasses over token ids — tokenization is the caller's concern
(scripts/serve.py shows the CLI wiring). Sampling semantics mirror
``models/decode.py``: temperature<=0 is greedy; top_k<=0 and top_p>=1 keep
the full distribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (HF generate analogue). ``eos_id < 0``
    disables early stopping; ``seed`` makes a sampled request reproducible
    independent of what else shares its decode batch (per-slot PRNG keys)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 64
    eos_id: int = -1
    seed: int = 0


@dataclass
class Request:
    prompt_ids: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = ""  # engine assigns "req-N" when empty
    # ---- QoS / fairness surface (docs/serving.md "QoS, fairness & overload")
    # SLO class name; must name one of the engine's configured classes
    # (EngineConfig.classes). With a single-class engine ANY label is
    # accepted into that one queue — the seed-FIFO configuration.
    priority: str = "interactive"
    # fairness key: admission round-robins across tenants inside each class
    # and per-tenant in-flight caps count against it. "" = the default
    # tenant (single-tenant deployments never need to set it).
    tenant: str = ""
    # optional end-to-end deadline in seconds from submit. A request still
    # WAITING (or still prefilling) past its deadline is cancelled — blocks
    # released, terminal finish_reason "deadline" — instead of burning pool
    # capacity on an answer nobody is waiting for. A request that finishes
    # late keeps its tokens but is marked deadline_missed (and excluded
    # from goodput_tokens_per_sec). None = no deadline.
    deadline_s: Optional[float] = None


@dataclass
class StreamEvent:
    """One generated token, emitted as soon as its decode (or prefill) step
    lands. ``index`` is the token's position in the request's generated
    stream (0 = first token after the prompt)."""

    request_id: str
    token: int
    index: int
    finished: bool = False
    finish_reason: str = ""  # "eos" | "length" when finished (cancellation
    # and rejection produce no token, hence no StreamEvent — read the
    # terminal status off RequestOutput.finish_reason)


@dataclass
class RequestOutput:
    request_id: str
    prompt_ids: List[int]
    token_ids: List[int] = field(default_factory=list)
    finished: bool = False
    # "eos" | "length" for normal completion; terminal QoS statuses:
    # "rejected"  — load-shed at submit (bounded queue / tenant cap; the
    #               429-equivalent: no tokens were ever produced),
    # "deadline"  — cancelled while waiting/prefilling past deadline_s,
    # "cancelled" — explicit InferenceEngine.cancel()
    finish_reason: str = ""
    # finished after its deadline_s elapsed (tokens kept, but the request
    # does not count toward serve.goodput_tokens_per_sec)
    deadline_missed: bool = False
    ttft_s: Optional[float] = None  # wall time submit -> first token
    # per-request lifecycle rollup (observability/request_trace.py): total
    # time spent waiting for a decode slot (initial + every post-preemption
    # re-admission wait), decode time-per-output-token, and how often the
    # scheduler preempted this request — the "why was request X slow" triple
    queue_wait_s: Optional[float] = None
    tpot_s: Optional[float] = None
    preemptions: int = 0
    # prompt positions served from the prefix cache on the LATEST admission
    # (0 with the cache off or on a cold miss) — cached_tokens/len(prompt_ids)
    # is this request's share of the engine's serve.prefix_hit_rate
    cached_tokens: int = 0
    # generated tokens that arrived as ACCEPTED speculative drafts (verify
    # steps, spec_k > 0) rather than one-token decode steps — this
    # request's share of serve.spec_accepted. 0 with speculation off.
    spec_accepted_tokens: int = 0
