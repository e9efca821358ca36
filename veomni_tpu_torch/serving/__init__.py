"""Continuous-batching inference engine with a paged KV cache.

Port of ``veomni_tpu/serving/``. Layering: ``api`` (request/response
dataclasses, incl. the per-request QoS surface) -> ``kv_block_manager``
(host block accounting: shared refcounted blocks) -> ``prefix_cache``
(radix tree sharing prompt KV blocks across requests) -> ``scheduler`` (QoS
admission, tenant fairness, bounded intake, class-aware LIFO preemption) ->
``spec_decode`` (host-side draft strategies, registry-dispatched) ->
``engine`` (chunked prefill over cached prefixes + batched paged decode,
one-token or draft-then-verify; dense or int8 KV blocks and decode
weights) -> ``quality`` (the fixed-seed gate of the int8 tiers) ->
``weights`` (versioned payloads, the checkpoint publish gate) ->
``replica``/``router`` (the self-healing prefix-affinity router over
engine replicas).
"""

from veomni_tpu_torch.serving import spec_decode  # noqa: F401  (registers the spec_draft op)
from veomni_tpu_torch.serving.api import Request, RequestOutput, SamplingParams, StreamEvent
from veomni_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from veomni_tpu_torch.serving.kv_block_manager import KVBlockManager
from veomni_tpu_torch.serving.prefix_cache import PrefixCache
from veomni_tpu_torch.serving.quality import (
    assert_quality_gate,
    fixed_corpus,
    quality_stats,
    teacher_forced_logits,
)
from veomni_tpu_torch.serving.replica import ReplicaHandle
from veomni_tpu_torch.serving.router import Router, RouterConfig
from veomni_tpu_torch.serving.scheduler import (
    DEFAULT_CLASSES,
    QoSPicker,
    Scheduler,
    SequenceState,
    parse_classes,
)
from veomni_tpu_torch.serving.weights import (
    WeightRecord,
    WeightStore,
    host_state,
    load_checkpoint_params,
    load_published_params,
)

__all__ = [
    "DEFAULT_CLASSES",
    "EngineConfig",
    "InferenceEngine",
    "KVBlockManager",
    "PrefixCache",
    "QoSPicker",
    "ReplicaHandle",
    "Request",
    "RequestOutput",
    "Router",
    "RouterConfig",
    "SamplingParams",
    "Scheduler",
    "SequenceState",
    "StreamEvent",
    "WeightRecord",
    "WeightStore",
    "assert_quality_gate",
    "fixed_corpus",
    "host_state",
    "load_checkpoint_params",
    "load_published_params",
    "parse_classes",
    "quality_stats",
    "teacher_forced_logits",
]
