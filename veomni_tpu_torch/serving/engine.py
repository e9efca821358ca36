"""In-process continuous-batching inference engine over a paged KV cache.

Port of ``veomni_tpu/serving/engine.py``. Execution model (one ``step()``
tick):

0. **Expire**: waiting (and still-prefilling) requests past their
   ``deadline_s`` are cancelled (blocks released, terminal ``deadline``
   status).
1. **Admit**: free slots are filled from the waiting queue by the QoS pick
   (per-class stride weights, per-tenant round robin; plain FIFO with a
   single class); admission matches each prompt against the prefix cache
   (when enabled) and allocates only the uncached suffix's blocks. Intake is
   bounded: past ``queue_bound`` waiting requests (or a tenant's
   ``tenant_max_inflight``), ``submit()`` load-sheds with a terminal
   ``rejected`` output.
2. **Prefill (chunked)**: every admitted-but-unfinished prefill advances by
   ONE chunk per tick (``paged_prefill_step``, attending over the cached
   prefix through the block table); the final chunk's logits sample the
   first token. With chunking off the whole uncached suffix is one chunk,
   and with the cache off too the path is the monolithic contiguous prefill
   plus ``scatter_prompt_cache``.
3. **Capacity**: every decoding sequence is grown to cover its next write
   position; cached (refcount-0) blocks are evicted LRU first, and only a
   dry pool preempts LIFO (recompute).
4. **Batched decode**: one ``paged_decode_step`` over the fixed slot batch
   (per-slot positions, block tables, PRNG keys and sampling params). The
   gathered-context width (the power-of-two bucket of the widest running
   block table) is the only shape that varies. With ``spec_k > 0`` the tick
   is draft-then-verify: a host-side drafter (``serving/spec_decode.py``)
   proposes up to k tokens per slot, blocks for the drafted positions are
   claimed best-effort, and ONE ``paged_verify_step`` scores all k+1
   positions, emitting 1..k+1 tokens per slot while staying token-exact with
   the one-token path (the verify step replays the per-token key schedule).

PyTorch idiom in place of the reference's jitted programs: the engine holds
the compute-dtype parameter set (cast once, at construction and in
``swap_weights``) and the two KV pools on its device, and every step writes
the pools in place (their storage never moves). ``decode.TRACE_COUNTS``
counts the distinct bucket shapes each of this engine's programs runs at,
which is what the reference's per-engine jits would trace; the
``recompile_warmup_ticks`` detector reads it as before. The reference's
``SharedPrograms`` (one compiled bundle for the router's replicas) has no
counterpart: the port's engines compile nothing to share.

Quantized tiers (reference ``:254-267``): ``kv_quant="int8"`` allocates
``QuantizedKV`` pools (quantized on write, dequantized in the gathered
attend), ``weight_quant="int8"`` stores each layer's dense projections as
``QuantizedWeight`` (quantized from the model's own parameters at
construction and again at every ``swap_weights``); ``kv_capacity`` reports
the int8 bytes. ``model`` is a ``Transformer`` or a flat ``{name: tensor}``
state with its parameter names (the router's host payloads), which the
engine casts (and quantizes) into its own copy on its device.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from veomni_tpu_torch.models import decode as decode_mod
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.observability.cost import instrument_site
from veomni_tpu_torch.observability.metrics import LabelledRegistry, get_registry
from veomni_tpu_torch.observability.request_trace import RequestTracer
from veomni_tpu_torch.observability.spans import span
from veomni_tpu_torch.ops import threefry
from veomni_tpu_torch.ops.quantization import kv_pool_nbytes, make_kv_pool, param_leaves
from veomni_tpu_torch.resilience.faults import fault_point
from veomni_tpu_torch.serving.api import Request, RequestOutput, SamplingParams, StreamEvent
from veomni_tpu_torch.serving.kv_block_manager import KVBlockManager
from veomni_tpu_torch.serving.prefix_cache import PrefixCache
from veomni_tpu_torch.serving.scheduler import Scheduler, SequenceState, parse_classes
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device
from veomni_tpu_torch.utils.helper import host_floats
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class EngineConfig:
    """Static engine shape knobs."""

    num_slots: int = 4  # decode batch width
    block_size: int = 16  # cache positions per KV block (power of two)
    max_model_len: int = 2048  # prompt + generated ceiling per request
    num_blocks: int = 0  # 0 -> 1 + num_slots * blocks(max_model_len)
    log_every_steps: int = 0  # 0 disables periodic metric logging
    # share full prompt blocks across requests (radix prefix cache over the
    # block pool; refcounted, LRU-evicted under pressure). OFF: exclusive
    # blocks, monolithic prefill.
    prefix_cache: bool = True
    # prefill at most this many tokens per step() tick (0 = the whole
    # uncached suffix in one go)
    prefill_chunk: int = 0
    # speculative decoding: propose up to spec_k tokens per running slot per
    # tick via the spec_draft strategy and verify them in ONE batched step
    spec_k: int = 0
    spec_draft: str = "ngram"  # registry impl name (serving/spec_decode.py)
    # QoS classes, "name:weight,..." highest priority first; a single class
    # is plain FIFO and admits any priority label
    classes: str = "interactive:4,batch:1"
    # max waiting requests before submit() sheds (terminal "rejected").
    # 0 = unbounded.
    queue_bound: int = 0
    # per-tenant cap on waiting+running requests. 0 = uncapped.
    tenant_max_inflight: int = 0
    # KV block storage: "none" (dense compute-dtype pool) or "int8"
    # (QuantizedKV); "fp8" raises NotImplementedError at construction, as the
    # reference's does
    kv_quant: str = "none"
    # decode weight storage: "none" or "int8" (QuantizedWeight projections)
    weight_quant: str = "none"
    # after this many step() ticks the TRACE_COUNTS baselines are armed and
    # any later bucket growth emits the RECOMPILE warning + the
    # `recompiles` counter. 0 disables.
    recompile_warmup_ticks: int = 256
    # metric-instance label inserted after the family prefix of every serve.*
    # instrument (serve.queue_depth -> serve.r0.queue_depth); "" keeps the
    # single-engine names
    metrics_label: str = ""

    def __post_init__(self):
        if self.block_size < 1 or (self.block_size & (self.block_size - 1)):
            raise ValueError("block_size must be a power of two")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 disables)")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables)")
        if self.queue_bound < 0:
            raise ValueError("queue_bound must be >= 0 (0 = unbounded)")
        if self.tenant_max_inflight < 0:
            raise ValueError("tenant_max_inflight must be >= 0 (0 = uncapped)")
        if self.kv_quant not in ("none", "int8", "fp8"):
            raise ValueError(f"kv_quant must be 'none', 'int8' or 'fp8', got {self.kv_quant!r}")
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant must be 'none' or 'int8', got {self.weight_quant!r}")
        if self.metrics_label and not all(c.isalnum() or c in "_-" for c in self.metrics_label):
            raise ValueError(f"metrics_label must be [A-Za-z0-9_-]*, got {self.metrics_label!r}")
        # malformed class specs fail at construction, not mid-serve
        parse_classes(self.classes)
        if self.num_blocks <= 0:
            per_seq = -(-self.max_model_len // self.block_size)
            self.num_blocks = 1 + self.num_slots * per_seq


def kv_capacity_stats(blocks: KVBlockManager, k_pool, v_pool,
                      max_model_len: int = 0) -> Dict[str, float]:
    """Block-pool capacity in operator units (the reference's
    ``observability/devmem.py::kv_capacity_stats``): pool bytes, bytes per
    block, and the estimated ceiling on resident max-length sequences, in
    total and over the blocks free now."""
    pool_bytes = kv_pool_nbytes(k_pool) + kv_pool_nbytes(v_pool)
    usable = max(1, blocks.num_blocks - 1)  # block 0 is the null block
    per_seq = blocks.blocks_for(max_model_len) if max_model_len else 1
    return {
        "pool_bytes": pool_bytes,
        "block_bytes": pool_bytes / blocks.num_blocks,
        "block_size": float(blocks.block_size),
        "num_blocks": float(blocks.num_blocks),
        "blocks_free": float(blocks.num_free),
        "blocks_per_max_len_seq": float(per_seq),
        "max_concurrent_seqs": float(usable // per_seq),
        "free_concurrent_seqs": float(blocks.num_free // per_seq),
    }


class InferenceEngine:
    """Continuous-batching generation over a fixed slot batch.

    ``submit()`` enqueues, ``step()`` advances every in-flight request by
    one token (and every in-flight prefill by one chunk), ``generate()``
    streams events, ``run()`` drains to completion. Single-threaded by
    design: callers own the pump loop; other threads read only the metrics
    registry and the RequestTracer, which lock internally.

    ``model`` is a ``Transformer`` whose parameters lie on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``; no card raises), or
    a flat ``{name: tensor}`` state of one on any device."""

    def __init__(self, model, cfg: TransformerConfig, config: Optional[EngineConfig] = None,
                 *, device: DeviceLike = None):
        decode_mod.check_decode_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = config or EngineConfig()
        ec = self.config
        self.params = self._cast(model)

        shape = (cfg.num_hidden_layers, ec.num_blocks, ec.block_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        self.k_pool = make_kv_pool(shape, ec.kv_quant, cfg.dtype, self.device)
        self.v_pool = make_kv_pool(shape, ec.kv_quant, cfg.dtype, self.device)
        self.blocks = KVBlockManager(ec.num_blocks, ec.block_size)
        self.prefix_cache = PrefixCache(self.blocks) if ec.prefix_cache else None
        # weight-publication epoch: bumped by swap_weights()
        self.cache_epoch = 0
        reg = get_registry()
        if ec.metrics_label:
            reg = LabelledRegistry(reg, ec.metrics_label)
        self._registry = reg
        # per-request lifecycle tracing: the scheduler reports queued/
        # admitted/preempted, the engine prefill/first-token/finished
        self.tracer = RequestTracer(ec.num_slots, registry=reg)
        # draft-then-verify: resolve the drafter up front (a typo'd
        # spec_draft fails here, not mid-serve); an ops-config pin outranks
        # the engine knob, including for the enabled/disabled decision
        from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY
        from veomni_tpu_torch.serving.spec_decode import resolve_draft_fn

        effective_draft = KERNEL_REGISTRY.pinned("spec_draft") or ec.spec_draft
        self._spec_enabled = ec.spec_k > 0 and effective_draft != "off"
        self._draft_fn = resolve_draft_fn(ec.spec_draft) if self._spec_enabled else None
        spec_headroom = -(-ec.spec_k // ec.block_size) if self._spec_enabled else 0
        self.scheduler = Scheduler(ec.num_slots, self.blocks, tracer=self.tracer,
                                   prefix_cache=self.prefix_cache,
                                   spec_headroom_blocks=spec_headroom,
                                   classes=parse_classes(ec.classes),
                                   queue_bound=ec.queue_bound,
                                   tenant_max_inflight=ec.tenant_max_inflight)
        # the bucket shapes each of this engine's programs has run at (the
        # monolithic prefill shares the config's program with greedy_generate)
        self._programs = {name: decode_mod.Program(name)
                          for name in ("paged_decode", "paged_prefill", "paged_verify")}
        # the cost census (observability/cost.py) counts each bucket's first
        # call in the process for this model and tier, whichever engine makes
        # it: the slot batch and table width of a decode or verify step, the
        # chunk and table width of a prefill chunk (the reference's
        # instrument_jit buckets, veomni_tpu/serving/engine.py:475-531); on
        # demand, only while a reader (the exporter) runs, so the counting
        # pass stays off the hot path of a server without one
        program = (repr(cfg), ec.kv_quant, ec.weight_quant, ec.block_size, str(self.device))
        self._decode_step = instrument_site(
            "paged_decode", self._decode_step, on_demand=True, program=program,
            bucket_fn=lambda a: f"s{a[0].shape[0]}_nbb{a[0].shape[1]}")
        self._prefill_chunk_step = instrument_site(
            "paged_prefill", self._prefill_chunk_step, on_demand=True, program=program,
            bucket_fn=lambda a: f"cb{a[4]}_nbb{a[0].shape[0]}")
        self._verify_step = instrument_site(
            "paged_verify", self._verify_step, on_demand=True, program=program,
            bucket_fn=lambda a: f"s{a[0].shape[0]}_nbb{a[0].shape[1]}_kb{a[2].shape[1]}")

        self._outputs: Dict[str, RequestOutput] = {}
        self._req_counter = 0
        self._step_counter = 0
        # batched model steps run (plain decode or verify), one per tick
        # that decodes: with the prefill chunks, the count of model passes
        self.decode_steps = 0
        # metrics: TTFT accumulators (lifetime + window), a decode-throughput
        # window and prefix-cache totals. The window accumulators are read
        # AND reset from outside the pump thread (metrics(reset_window=True)
        # from concurrent scrapers): snapshot+reset is atomic under
        # _metrics_lock, which pump-side increments take too.
        self._metrics_lock = threading.Lock()
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._win_ttft_sum = 0.0  # guarded-by: _metrics_lock
        self._win_ttft_n = 0  # guarded-by: _metrics_lock
        self._total_generated = 0
        self._window_tokens = 0  # guarded-by: _metrics_lock
        self._window_t0 = time.perf_counter()  # guarded-by: _metrics_lock
        self._prompt_tokens_total = 0
        self._cached_tokens_total = 0
        self._prefill_chunks_total = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._win_spec_proposed = 0  # guarded-by: _metrics_lock
        self._win_spec_accepted = 0  # guarded-by: _metrics_lock
        self._rejected_total = 0
        self._shed_tokens_total = 0
        self._deadline_miss_total = 0
        self._goodput_tokens_total = 0
        self._win_goodput_tokens = 0  # guarded-by: _metrics_lock
        self._m_requests = reg.counter("serve.requests")
        self._m_tokens = reg.counter("serve.generated_tokens")
        self._m_ttft = reg.histogram("serve.ttft_s")
        self._m_queue = reg.gauge("serve.queue_depth")
        self._m_running = reg.gauge("serve.num_running")
        self._m_kv = reg.gauge("serve.kv_utilization")
        self._m_preempt = reg.gauge("serve.preemptions")
        self._m_tps = reg.gauge("serve.decode_tokens_per_sec")
        self._m_hit_rate = reg.gauge("serve.prefix_hit_rate")
        self._m_cached_tokens = reg.counter("serve.cached_tokens")
        self._m_chunks = reg.counter("serve.prefill_chunks")
        self._m_spec_proposed = reg.counter("serve.spec_proposed")
        self._m_spec_accepted = reg.counter("serve.spec_accepted")
        self._m_spec_rate = reg.gauge("serve.spec_acceptance_rate")
        self._m_rejected = reg.counter("serve.rejected")
        self._m_shed_tokens = reg.counter("serve.shed_tokens")
        self._m_deadline_misses = reg.counter("serve.deadline_misses")
        self._m_goodput = reg.gauge("serve.goodput_tokens_per_sec")
        # pool capacity: bytes are static per engine; the concurrent-sequence
        # estimates answer "how many max-length users fit"
        self._m_kv_pool_bytes = reg.gauge("serve.kv_pool_bytes")
        self._m_kv_block_bytes = reg.gauge("serve.kv_block_bytes")
        self._m_kv_max_seqs = reg.gauge("serve.kv_max_concurrent_seqs")
        self._m_kv_free_seqs = reg.gauge("serve.kv_free_concurrent_seqs")
        cap = self.kv_capacity()
        self._m_kv_pool_bytes.set(cap["pool_bytes"])
        self._m_kv_block_bytes.set(cap["block_bytes"])
        self._m_kv_max_seqs.set(cap["max_concurrent_seqs"])
        self._m_kv_free_seqs.set(cap["free_concurrent_seqs"])
        # serving-side recompile detection over the bucket counters, armed
        # after the warmup grace window (step())
        self._recompile_detector = None
        if ec.recompile_warmup_ticks > 0:
            from veomni_tpu_torch.observability.goodput import RecompileDetector

            self._recompile_detector = RecompileDetector(
                [("serve_decode", decode_mod.TRACE_COUNTS)], registry=reg,
            )

    # ------------------------------------------------------------ programs
    def _cast(self, model):
        """The compute-dtype parameter set (int8 projections under
        ``weight_quant="int8"``) on the engine's device, from a
        ``Transformer`` on that device or a state on any device."""
        if not isinstance(model, Mapping):
            dev = model.embed_tokens.device
            if dev.type != self.device.type or self.device.index not in (None, dev.index):
                raise ValueError(f"the model's parameters are on {dev}, the engine runs on "
                                 f"{self.device}")
        with torch.no_grad():
            return decode_mod._compute_cast(model, self.cfg, weight_quant=self.config.weight_quant,
                                            device=self.device)

    def _tensor(self, array) -> torch.Tensor:
        """A host array as a tensor on the engine's device (integers int64)."""
        a = np.asarray(array)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(self.device)

    def _decode_step(self, tables, positions, tokens, keys, temps, top_ks, top_ps):
        self._programs["paged_decode"].see(tuple(tables.shape))
        logits = decode_mod.paged_decode_step(self.params, self.cfg, (self.k_pool, self.v_pool),
                                              tables, positions, tokens)
        # per-slot key split mirrors the contiguous decode's (carry, sample)
        pair = threefry.split(keys)
        nxt = decode_mod.sample_tokens(logits, pair[:, 1], temps, top_ks, top_ps)
        return nxt, pair[:, 0]

    def _prefill_chunk_step(self, table, start: int, tokens, chunk_len: int, chunk_bucket: int):
        self._programs["paged_prefill"].see((chunk_bucket, table.shape[0]))
        return decode_mod.paged_prefill_step(self.params, self.cfg, (self.k_pool, self.v_pool),
                                             table, start, tokens, chunk_len, chunk_bucket)

    def _verify_step(self, tables, positions, tokens, n_input, keys, temps, top_ks, top_ps):
        self._programs["paged_verify"].see((tuple(tables.shape), tuple(tokens.shape)))
        logits = decode_mod.paged_verify_step(self.params, self.cfg, (self.k_pool, self.v_pool),
                                              tables, positions, tokens, n_input)
        return decode_mod.verify_accept(logits, tokens, n_input, keys, temps, top_ks, top_ps)

    # ----------------------------------------------------------------- intake
    def submit(self, request: Union[Request, Iterable[int]],
               sampling: Optional[SamplingParams] = None) -> str:
        """Enqueue a request (a ``Request`` or a bare prompt-id iterable).
        Returns the request id; tokens arrive via ``step()`` events.

        Under overload (waiting queue at ``queue_bound`` or the tenant at
        ``tenant_max_inflight``) the request is load-shed: its
        ``RequestOutput`` is already terminal with
        ``finish_reason="rejected"``. Malformed requests (empty prompt,
        over-length, unknown priority class) raise ``ValueError``."""
        fault_point("serve.admit")
        if not isinstance(request, Request):
            request = Request(prompt_ids=[int(t) for t in request],
                              sampling=sampling or SamplingParams())
        if not request.request_id:
            # skip over user-supplied ids that happen to look like ours
            while f"req-{self._req_counter}" in self._outputs:
                self._req_counter += 1
            request.request_id = f"req-{self._req_counter}"
            self._req_counter += 1
        if request.request_id in self._outputs:
            raise ValueError(f"duplicate request id {request.request_id!r}")
        if not request.prompt_ids:
            raise ValueError("empty prompt")
        sp = request.sampling
        if sp.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(request.prompt_ids) + sp.max_new_tokens
        if total > self.config.max_model_len:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds max_model_len="
                             f"{self.config.max_model_len}")
        if self.blocks.blocks_for(total) > self.config.num_blocks - 1:
            raise ValueError(f"request needs {self.blocks.blocks_for(total)} blocks; pool "
                             f"has {self.config.num_blocks - 1}")
        if request.deadline_s is not None and request.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0 (None disables)")
        seq = SequenceState(request=request, rng=threefry.prng_key(sp.seed))
        out = RequestOutput(request_id=request.request_id, prompt_ids=list(request.prompt_ids))
        # may raise ValueError (unknown priority class) BEFORE the output
        # registers: malformed is an error, overloaded is an outcome
        accepted = self.scheduler.add(seq)
        self._outputs[request.request_id] = out
        self._m_requests.inc()
        if not accepted:
            out.finished = True
            out.finish_reason = "rejected"
            shed = len(request.prompt_ids) + sp.max_new_tokens
            self._rejected_total += 1
            self._shed_tokens_total += shed
            self._m_rejected.inc()
            self._m_shed_tokens.inc(shed)
            self.tracer.on_rejected(request.request_id)
            return request.request_id
        self._m_queue.set(self.scheduler.queue_depth)
        return request.request_id

    # ---------------------------------------------------------- weight swap
    def swap_weights(self, model) -> Dict[str, int]:
        """Swap the engine's weights in place from ``model`` (a Transformer
        of the same architecture, or its state), invalidating all cached KV.
        The engine must be drained; the new parameter set, cast (and under
        ``weight_quant="int8"`` quantized again) as at construction, must
        match the current one in shape and dtype; the prefix cache is
        flushed under a bumped ``cache_epoch``. Returns
        ``{"flushed_blocks": n, "cache_epoch": e}``."""
        if self.scheduler.has_work:
            raise RuntimeError("swap_weights on a busy engine: drain waiting/running "
                               "sequences first")
        new = self._cast(model)
        old_leaves, new_leaves = param_leaves(self.params), param_leaves(new)
        if [k for k, _ in old_leaves] != [k for k, _ in new_leaves]:
            raise ValueError("swap_weights payload structure differs from the serving "
                             "weights: a publish must carry the same model")
        for (name, o), (_, n) in zip(old_leaves, new_leaves):
            if (o.shape, o.dtype) != (n.shape, n.dtype):
                raise ValueError(f"swap_weights payload leaf {name} is {(n.shape, n.dtype)}, "
                                 f"serving weights have {(o.shape, o.dtype)}: shape/dtype-"
                                 f"incongruent payloads are refused")
        self.params = new
        flushed = self.prefix_cache.flush() if self.prefix_cache is not None else 0
        self.cache_epoch += 1
        self._registry.counter("serve.weights_swaps").inc()
        self._registry.counter("serve.weights_flushed_blocks").inc(flushed)
        return {"flushed_blocks": flushed, "cache_epoch": self.cache_epoch}

    # ------------------------------------------------------------------ drive
    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self) -> List[StreamEvent]:
        """One engine tick: expire deadlines, admit, advance every in-flight
        prefill by one chunk, secure blocks, batched decode. Returns every
        token event produced this tick (cancellations produce none: their
        terminal status lands on the RequestOutput)."""
        events: List[StreamEvent] = []
        with torch.inference_mode():
            self._expire_deadlines()
            for seq in self.scheduler.admit():
                self._start_prefill(seq)
            # one chunk per prefilling sequence per tick: decode of running
            # requests interleaves between chunks
            prefilling = [s for _, s in self.scheduler.running() if s.prefilling]
            for seq in prefilling:
                with span("serve.prefill"):
                    events.extend(self._prefill_tick(seq))
            self.scheduler.ensure_decode_capacity()
            decodable = [(i, s) for i, s in self.scheduler.running() if not s.prefilling]
            if decodable:
                with span("serve.decode"):
                    events.extend(self._decode_tick(decodable))
            elif not events and not prefilling and self.scheduler.has_work:
                raise RuntimeError("scheduler stalled: waiting requests but nothing running "
                                   "and nothing admissible (pool misconfigured?)")
        self._step_counter += 1
        self._m_queue.set(self.scheduler.queue_depth)
        self._m_running.set(self.scheduler.num_running)
        self._m_kv.set(self.blocks.utilization())
        self._m_preempt.set(self.scheduler.preemption_count)
        per_seq = max(1, self.blocks.blocks_for(self.config.max_model_len))
        self._m_kv_free_seqs.set(self.blocks.num_free // per_seq)
        det = self._recompile_detector
        if det is not None:
            grace = self.config.recompile_warmup_ticks
            if self._step_counter == grace:
                det.arm()  # warmup bucket shapes absorbed
            elif self._step_counter > grace:
                det.check()
        le = self.config.log_every_steps
        if le and self._step_counter % le == 0:
            # non-resetting read: periodic logging must not clobber the
            # throughput window of an external metrics() consumer
            m = self.metrics(reset_window=False)
            logger.info("serve step %d | %s", self._step_counter,
                        " ".join(f"{k}={v:.4g}" for k, v in sorted(m.items())))
        return events

    def generate(self, requests: Optional[Iterable] = None) -> Iterator[StreamEvent]:
        """Streaming interface: submit ``requests`` (if given), then yield
        token events until all in-flight work drains."""
        for r in requests or ():
            self.submit(r)
        while self.has_work:
            yield from self.step()

    def run(self, requests: Optional[Iterable] = None) -> Dict[str, RequestOutput]:
        """Drain ``generate()`` and return {request_id: RequestOutput} for
        every finished request, releasing the retained outputs."""
        for _ in self.generate(requests):
            pass
        done = {rid: o for rid, o in self._outputs.items() if o.finished}
        for rid in done:
            del self._outputs[rid]
        return done

    def backdate_submit_time(self, request_id: str, submit_time: float) -> None:
        """Rewind a just-submitted request's deadline clock to an upstream
        arrival time (only ever back, and only while in flight)."""
        seq = self._find_seq(request_id)
        if seq is not None:
            seq.submit_time = min(seq.submit_time, float(submit_time))

    def get_output(self, request_id: str) -> Optional[RequestOutput]:
        """Read-only peek at a request's output, in flight or finished."""
        return self._outputs.get(request_id)

    def pop_output(self, request_id: str) -> Optional[RequestOutput]:
        """Release and return one finished request's output; refuses while
        the request is in flight."""
        out = self._outputs.get(request_id)
        if out is not None and not out.finished:
            raise ValueError(f"request {request_id!r} is still in flight")
        return self._outputs.pop(request_id, None)

    # ----------------------------------------------------- QoS / cancellation
    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Cancel an in-flight (waiting, prefilling, or decoding) request:
        its blocks (partial chunked-prefill claims and a pinned copy-on-write
        source included) return to the pool and its output turns terminal
        with ``finish_reason=reason``. False when unknown or finished."""
        out = self._outputs.get(request_id)
        if out is None or out.finished:
            return False
        seq = self._find_seq(request_id)
        if seq is None:
            return False
        self._cancel_seq(seq, reason)
        return True

    def _find_seq(self, request_id: str) -> Optional[SequenceState]:
        for s in self.scheduler.waiting:
            if s.seq_id == request_id:
                return s
        for _, s in self.scheduler.running():
            if s.seq_id == request_id:
                return s
        return None

    def _expire_deadlines(self) -> None:
        """Cancel waiting/prefilling requests past their deadline, BEFORE
        admission, so freed blocks admit someone else the same tick."""
        for seq in self.scheduler.expired():
            self._cancel_seq(seq, "deadline")

    def _cancel_seq(self, seq: SequenceState, reason: str) -> None:
        self.scheduler.cancel(seq)
        out = self._outputs[seq.seq_id]
        out.finished = True
        out.finish_reason = reason
        if reason == "deadline":
            out.deadline_missed = True
            self._deadline_miss_total += 1
            self._m_deadline_misses.inc()
        # offered work the cancellation turned away: all of it if nothing was
        # emitted yet, else the un-generated remainder
        if seq.generated:
            shed = seq.request.sampling.max_new_tokens - len(seq.generated)
        else:
            shed = len(seq.request.prompt_ids) + seq.request.sampling.max_new_tokens
        if shed > 0:
            self._shed_tokens_total += shed
            self._m_shed_tokens.inc(shed)
        tl = self.tracer.on_finished(seq.seq_id, reason, len(seq.generated))
        if tl is not None:
            out.queue_wait_s = tl.queue_wait_s
            out.tpot_s = tl.tpot_s
            out.preemptions = tl.preemptions
        self._m_queue.set(self.scheduler.queue_depth)

    # --------------------------------------------------------------- internals
    def _start_prefill(self, seq: SequenceState) -> None:
        """Per-admission bookkeeping: prefix-cache accounting and the
        copy-on-write copy of a fully-cached prompt's divergence block (it
        MUST land before any chunk writes into it)."""
        p = len(seq.recompute_prompt)
        self._prompt_tokens_total += p
        if seq.cached_tokens:
            self._cached_tokens_total += seq.cached_tokens
            self._m_cached_tokens.inc(seq.cached_tokens)
        self._m_hit_rate.set(self._cached_tokens_total / max(1, self._prompt_tokens_total))
        out = self._outputs.get(seq.seq_id)
        if out is not None:
            out.cached_tokens = seq.cached_tokens
        if seq.cow_src is not None:
            dst = self.blocks.table(seq.seq_id)[-1]
            decode_mod.copy_block((self.k_pool, self.v_pool), seq.cow_src, dst)
            # the source was pinned at admission so claiming fresh blocks
            # could not evict it before this copy; release it now
            self.blocks.release_block(seq.cow_src)
            seq.cow_src = None

    def _prefill_tick(self, seq: SequenceState) -> List[StreamEvent]:
        """Advance one sequence's prefill by one chunk (monolithic on a cache
        miss with chunking off)."""
        fault_point("serve.prefill")
        if seq.cached_tokens == 0 and self.config.prefill_chunk <= 0:
            return self._prefill_monolithic(seq)
        return self._prefill_chunk(seq)

    def _prefill_monolithic(self, seq: SequenceState) -> List[StreamEvent]:
        bs = self.config.block_size
        prompt = seq.recompute_prompt
        pt = len(prompt)
        pb = decode_mod._bucket_pow2(pt, floor=max(16, bs))
        tokens = np.zeros((1, pb), np.int64)
        tokens[0, :pt] = prompt
        logits, caches = decode_mod.prefill(self.params, self.cfg, self._tensor(tokens), pt, pb, pb)
        # scatter the contiguous prompt cache into this sequence's blocks;
        # tail entries past the real allocation point at the null block
        ids = self.blocks.table(seq.seq_id)
        ids = ids + [KVBlockManager.NULL_BLOCK] * (pb // bs - len(ids))
        decode_mod.scatter_prompt_cache((self.k_pool, self.v_pool), caches, self._tensor(ids))
        self._prefill_chunks_total += 1
        self._m_chunks.inc()
        return self._finish_prefill(seq, logits)

    def _prefill_chunk(self, seq: SequenceState) -> List[StreamEvent]:
        bs = self.config.block_size
        prompt = seq.recompute_prompt
        p = len(prompt)
        start = seq.prefill_pos
        budget = self.config.prefill_chunk or (p - start)
        clen = min(budget, p - start)
        cb = decode_mod._bucket_pow2(clen, floor=max(16, bs))
        tokens = np.zeros(cb, np.int64)
        tokens[:clen] = prompt[start:start + clen]
        ids = self.blocks.table(seq.seq_id)
        nbb = decode_mod._bucket_pow2(len(ids), floor=1)
        table = np.zeros(nbb, np.int64)  # null-block padded
        table[: len(ids)] = ids
        logits = self._prefill_chunk_step(self._tensor(table), start, self._tensor(tokens),
                                          clen, cb)
        seq.prefill_pos = start + clen
        self._prefill_chunks_total += 1
        self._m_chunks.inc()
        if seq.prefill_pos < p:
            return []  # more chunks next tick; decode interleaves meanwhile
        return self._finish_prefill(seq, logits)

    def _finish_prefill(self, seq: SequenceState, logits) -> List[StreamEvent]:
        """Sample the first token from the last prompt row's logits, publish
        the full prompt blocks to the prefix cache, and flip the sequence
        into the decode batch."""
        sp = seq.request.sampling
        pair = threefry.split(seq.rng)
        seq.rng = pair[0].numpy().astype(np.uint32)
        first = int(decode_mod.sample_tokens(
            logits, pair[1:].to(self.device),
            self._tensor(np.full(1, sp.temperature, np.float32)),
            self._tensor(np.full(1, sp.top_k, np.int64)),
            self._tensor(np.full(1, sp.top_p, np.float32)),
        )[0])
        pt = len(seq.recompute_prompt)
        seq.prefill_len = pt
        seq.pos = pt  # the pending token's write position
        seq.prefill_pos = pt
        seq.prefilling = False
        # prompt blocks become shareable the moment they hold real KV
        self.scheduler.cache_insert(seq)
        self.tracer.on_prefill_done(seq.seq_id, cached_tokens=seq.cached_tokens)
        if seq.first_token_time is None:
            seq.first_token_time = time.perf_counter()
            ttft = seq.first_token_time - seq.submit_time
            self._outputs[seq.seq_id].ttft_s = ttft
            self._ttft_sum += ttft
            self._ttft_n += 1
            with self._metrics_lock:
                self._win_ttft_sum += ttft
                self._win_ttft_n += 1
            self._m_ttft.observe(ttft)
            self.tracer.on_first_token(seq.seq_id)
        else:
            # post-preemption re-admission: this resume token belongs to the
            # decode phase
            self.tracer.on_decode_tokens(seq.seq_id, 1)
        return [self._emit(seq, first)]

    def _decode_tick(self, running: List[Tuple[int, SequenceState]]) -> List[StreamEvent]:
        fault_point("serve.decode_tick")
        self.decode_steps += 1
        if self._spec_enabled:
            return self._spec_decode_tick(running)
        return self._plain_decode_tick(running)

    def _fill_slot_arrays(self, running: List[Tuple[int, SequenceState]]):
        """Per-slot batch rows shared by the plain and verify ticks, as
        device tensors: null-padded block tables (width = the power-of-two
        bucket of the widest running table), positions, PRNG keys and
        per-slot sampling params."""
        nbb = decode_mod._bucket_pow2(
            max(self.blocks.num_allocated(s.seq_id) for _, s in running), floor=1)
        S = self.config.num_slots
        tables = np.zeros((S, nbb), np.int64)  # null-block padded
        positions = np.zeros(S, np.int64)
        keys = np.zeros((S, 2), np.uint32)
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int64)
        top_ps = np.ones(S, np.float32)
        for slot, seq in running:
            tbl = self.blocks.table(seq.seq_id)
            tables[slot, : len(tbl)] = tbl
            positions[slot] = seq.pos
            keys[slot] = seq.rng
            sp = seq.request.sampling
            temps[slot] = sp.temperature
            top_ks[slot] = sp.top_k
            top_ps[slot] = sp.top_p
        return tuple(self._tensor(a) for a in (tables, positions, keys, temps, top_ks, top_ps))

    def _plain_decode_tick(self, running: List[Tuple[int, SequenceState]]) -> List[StreamEvent]:
        tables, positions, keys, temps, top_ks, top_ps = self._fill_slot_arrays(running)
        tokens = np.zeros(self.config.num_slots, np.int64)
        for slot, seq in running:
            tokens[slot] = seq.last_token
        nxt, new_keys = self._decode_step(tables, positions, self._tensor(tokens), keys, temps,
                                          top_ks, top_ps)
        nxt = nxt.tolist()
        new_keys = new_keys.cpu().numpy().astype(np.uint32)

        events = []
        for slot, seq in running:
            seq.rng = new_keys[slot]
            seq.pos += 1  # the freshly sampled token's write position
            self.tracer.on_decode_tokens(seq.seq_id, 1)
            events.append(self._emit(seq, int(nxt[slot])))
        return events

    def _spec_decode_tick(self, running: List[Tuple[int, SequenceState]]) -> List[StreamEvent]:
        """Draft-then-verify decode tick: host-side drafting per slot,
        best-effort speculative block claims, ONE batched verify step, then
        per-slot accept/rollback."""
        ec = self.config
        bs = ec.block_size
        # 1) draft + claim blocks for the drafted positions; a slot whose
        # drafter proposes nothing (or whose budget is spent) decodes plainly
        drafts: Dict[int, List[int]] = {}
        pre_lens: Dict[int, int] = {}
        for slot, seq in running:
            sp = seq.request.sampling
            # a verify tick emits up to k+1 tokens; never draft past the
            # request's remaining budget
            budget = sp.max_new_tokens - len(seq.generated) - 1
            k = min(ec.spec_k, max(0, budget))
            d = list(self._draft_fn(seq.recompute_prompt, k))[:k] if k else []
            if d:
                pre = self.blocks.num_allocated(seq.seq_id)
                k_granted, claimed = self.scheduler.claim_speculative(seq, len(d))
                d = d[:max(0, k_granted)]
                if not d and claimed:
                    # pool too dry for even one draft: roll the claim back
                    self.blocks.shrink(seq.seq_id, pre)
                else:
                    pre_lens[slot] = pre
            drafts[slot] = d
        if not any(drafts.values()):
            # nothing to verify anywhere: the plain decode step is cheaper
            return self._plain_decode_tick(running)

        # 2) ONE batched verify step over all slots; kb (committed token +
        # widest draft, power of two) and the table bucket are its shapes
        kb = decode_mod._bucket_pow2(1 + max(len(d) for d in drafts.values()), floor=2)
        tables, positions, keys, temps, top_ks, top_ps = self._fill_slot_arrays(running)
        S = ec.num_slots
        tokens = np.zeros((S, kb), np.int64)
        n_input = np.ones(S, np.int64)
        for slot, seq in running:
            d = drafts[slot]
            tokens[slot, 0] = seq.last_token
            if d:
                tokens[slot, 1:1 + len(d)] = d
            n_input[slot] = 1 + len(d)
        targets, n_emit, new_keys = self._verify_step(
            tables, positions, self._tensor(tokens), self._tensor(n_input), keys, temps,
            top_ks, top_ps)
        targets = targets.cpu().numpy()
        n_emit = n_emit.cpu().numpy()
        new_keys = new_keys.cpu().numpy().astype(np.uint32)

        # 3) per-slot accept + emit + rollback
        events: List[StreamEvent] = []
        for slot, seq in running:
            seq.rng = new_keys[slot]
            m = int(n_emit[slot])
            proposed = len(drafts[slot])
            accepted = m - 1  # drafts matching target sampling, in order
            # truncate at eos / budget BEFORE emitting
            sp = seq.request.sampling
            emit: List[int] = []
            for j in range(m):
                t = int(targets[slot, j])
                emit.append(t)
                if sp.eos_id >= 0 and t == sp.eos_id:
                    break
                if len(seq.generated) + len(emit) >= sp.max_new_tokens:
                    break
            # accepted drafts that LANDED as extra tokens
            accepted_emitted = min(accepted, len(emit) - 1)
            if proposed:
                self._spec_proposed_total += proposed
                self._m_spec_proposed.inc(proposed)
                self._spec_accepted_total += accepted_emitted
                self._m_spec_accepted.inc(accepted_emitted)
                with self._metrics_lock:
                    self._win_spec_proposed += proposed
                    self._win_spec_accepted += accepted_emitted
                self._outputs[seq.seq_id].spec_accepted_tokens += accepted_emitted
            self.tracer.on_decode_tokens(seq.seq_id, len(emit), spec_accepted=accepted_emitted)
            finished = False
            for t in emit:
                seq.pos += 1  # this token's write position
                ev = self._emit(seq, t)
                events.append(ev)
                if ev.finished:
                    finished = True
                    break
            if finished or slot not in pre_lens:
                continue  # finish freed every block / nothing was claimed
            # rollback: release claimed blocks past what the accepted extent
            # (plus the pending token's write position) needs
            keep = max(pre_lens[slot], seq.pos // bs + 1)
            self.blocks.shrink(seq.seq_id, keep)
        return events

    def _emit(self, seq: SequenceState, token: int) -> StreamEvent:
        """Record a sampled token, finishing the request on eos/length."""
        seq.generated.append(token)
        with self._metrics_lock:
            self._window_tokens += 1
        self._total_generated += 1
        self._m_tokens.inc()
        sp = seq.request.sampling
        out = self._outputs[seq.seq_id]
        out.token_ids.append(token)
        finished = False
        reason = ""
        if sp.eos_id >= 0 and token == sp.eos_id:
            finished, reason = True, "eos"
        elif len(seq.generated) >= sp.max_new_tokens:
            finished, reason = True, "length"
        if finished:
            self.scheduler.finish(seq)
            out.finished = True
            out.finish_reason = reason
            # goodput: a request finished within its deadline (or without
            # one) contributes its tokens; a late finish is a deadline miss
            if seq.deadline_expired(time.perf_counter()):
                out.deadline_missed = True
                self._deadline_miss_total += 1
                self._m_deadline_misses.inc()
            else:
                self._goodput_tokens_total += len(seq.generated)
                with self._metrics_lock:
                    self._win_goodput_tokens += len(seq.generated)
            tl = self.tracer.on_finished(seq.seq_id, reason, len(seq.generated))
            if tl is not None:
                out.queue_wait_s = tl.queue_wait_s
                out.tpot_s = tl.tpot_s
                out.preemptions = tl.preemptions
        return StreamEvent(request_id=seq.seq_id, token=token, index=len(seq.generated) - 1,
                           finished=finished, finish_reason=reason)

    # ---------------------------------------------------------------- metrics
    def revoke_metrics(self) -> None:
        """Fence off this engine's labelled metric writes (no-op for an
        unlabelled engine): a successor engine under the same label is then
        never double-counted by this one."""
        revoke = getattr(self._registry, "revoke", None)
        if revoke is not None:
            revoke()

    def kv_capacity(self) -> Dict[str, float]:
        """Block-pool capacity in operator units (pool bytes + estimated
        max-concurrent max-length sequences)."""
        return kv_capacity_stats(self.blocks, self.k_pool, self.v_pool,
                                 max_model_len=self.config.max_model_len)

    def metrics(self, reset_window: bool = True) -> Dict[str, float]:
        """Host-float engine metrics. ``decode_tokens_per_sec`` and
        ``ttft_avg_s`` cover the window since the last resetting call
        (``reset_window=False`` peeks); ``ttft_avg_lifetime_s`` never
        resets. Snapshot and reset are atomic under ``_metrics_lock``."""
        now = time.perf_counter()
        with self._metrics_lock:
            dt = max(now - self._window_t0, 1e-9)
            m = {
                "queue_depth": float(self.scheduler.queue_depth),
                "num_running": float(self.scheduler.num_running),
                "block_utilization": self.blocks.utilization(),
                "preemptions": float(self.scheduler.preemption_count),
                "generated_tokens": float(self._total_generated),
                "decode_tokens_per_sec": self._window_tokens / dt,
                "prefix_hit_rate": self._cached_tokens_total / max(1, self._prompt_tokens_total),
                "cached_tokens": float(self._cached_tokens_total),
                "prompt_tokens": float(self._prompt_tokens_total),
                "prefill_chunks": float(self._prefill_chunks_total),
                "spec_proposed": float(self._spec_proposed_total),
                "spec_accepted": float(self._spec_accepted_total),
                "spec_acceptance_rate": self._win_spec_accepted / max(1, self._win_spec_proposed),
                "rejected": float(self._rejected_total),
                "shed_tokens": float(self._shed_tokens_total),
                "deadline_misses": float(self._deadline_miss_total),
                "goodput_tokens": float(self._goodput_tokens_total),
                "goodput_tokens_per_sec": self._win_goodput_tokens / dt,
            }
            if self._win_ttft_n:
                m["ttft_avg_s"] = self._win_ttft_sum / self._win_ttft_n
            if self._ttft_n:
                m["ttft_avg_lifetime_s"] = self._ttft_sum / self._ttft_n
            if reset_window:
                self._m_tps.set(m["decode_tokens_per_sec"])
                self._m_spec_rate.set(m["spec_acceptance_rate"])
                self._m_goodput.set(m["goodput_tokens_per_sec"])
                self._window_tokens = 0
                self._win_goodput_tokens = 0
                self._window_t0 = now
                self._win_ttft_sum = 0.0
                self._win_ttft_n = 0
                self._win_spec_proposed = 0
                self._win_spec_accepted = 0
        return host_floats(m)
