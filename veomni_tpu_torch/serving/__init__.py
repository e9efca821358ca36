"""Continuous-batching inference engine with a paged KV cache.

Port of ``veomni_tpu/serving/``. Layering: ``api`` (request/response
dataclasses, incl. the per-request QoS surface) -> ``kv_block_manager``
(host block accounting: shared refcounted blocks) -> ``prefix_cache``
(radix tree sharing prompt KV blocks across requests) -> ``scheduler`` (QoS
admission, tenant fairness, bounded intake, class-aware LIFO preemption) ->
``spec_decode`` (host-side draft strategies, registry-dispatched) ->
``engine`` (chunked prefill over cached prefixes + batched paged decode,
one-token or draft-then-verify). The quantized tier's quality gate, the
weight store and the scale-out router are not ported yet (ROADMAP.md).
"""

from veomni_tpu_torch.serving import spec_decode  # noqa: F401  (registers the spec_draft op)
from veomni_tpu_torch.serving.api import Request, RequestOutput, SamplingParams, StreamEvent
from veomni_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from veomni_tpu_torch.serving.kv_block_manager import KVBlockManager
from veomni_tpu_torch.serving.prefix_cache import PrefixCache
from veomni_tpu_torch.serving.scheduler import (
    DEFAULT_CLASSES,
    QoSPicker,
    Scheduler,
    SequenceState,
    parse_classes,
)

__all__ = [
    "DEFAULT_CLASSES",
    "EngineConfig",
    "InferenceEngine",
    "KVBlockManager",
    "PrefixCache",
    "QoSPicker",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "Scheduler",
    "SequenceState",
    "StreamEvent",
    "parse_classes",
]
