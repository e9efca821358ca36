"""Command-line front end of the continuous-batching inference engine.

Port of ``scripts/serve.py``: the bare engine, or the self-healing
prefix-affinity router over ``--replicas`` engines. Operates on token ids:
synthetic random-prompt requests (``--synthetic N``), explicit prompts
(``--prompt-ids 5,17,3``, repeatable) and/or ``--requests-json`` (a JSON
list of request objects: ``{"prompt_ids": [...], "priority": ...,
"tenant": ..., "deadline_s": ..., "max_new_tokens": ..., "temperature":
..., "top_k": ..., "top_p": ..., "eos_id": ..., "seed": ...,
"request_id": ...}``, every field but ``prompt_ids`` optional; ``-`` reads
stdin). Prints the pool capacity line, one JSON line per token event, the
engine metrics, the terminal-status census and one line per request.

By default a tiny random-weight qwen3-style model; ``--preset`` takes a
``train_text_step.bench_config`` preset (``qwen3_0p6b``,
``qwen3_30b_a3b``, or a published config of ``HF_CONFIGS`` such as
``gpt_oss_20b``) with random weights from ``--seed``, and
``--model-path`` an HF directory (config.json and safetensors, e.g. a
trainer's ``hf_ckpt`` export) whose weights it loads in the compute dtype.
Runs on the card unless ``--device cpu``::

    python -m veomni_tpu_torch.tasks.serve --synthetic 8 --max-new 32
    python -m veomni_tpu_torch.tasks.serve --device cpu --synthetic 4 --max-new 8
    python -m veomni_tpu_torch.tasks.serve --preset qwen3_0p6b --synthetic 16 \
        --synthetic-len 512 --max-model-len 4096 --slots 16 --prefill-chunk 512
    python -m veomni_tpu_torch.tasks.serve --device cpu --synthetic 4 --replicas 2 \
        --kv-quant int8 --weight-quant int8 --publish-from out/checkpoints/global_step_10

``--kv-quant int8`` and ``--weight-quant int8`` serve the int8 tiers;
``--publish-from`` loads a port checkpoint generation
(``global_step_N/train_state/model.pt``) through the integrity gate
(``--publish-verify``) before a token is served, then rolls it into the
router's fleet after the first token (``--publish-version`` tags it,
default the directory's name) or swaps it into the bare engine before
serving.

Env knobs (flags win): VEOMNI_SERVE_SLOTS, VEOMNI_SERVE_BLOCK,
VEOMNI_SERVE_MAX_LEN, VEOMNI_SERVE_LOG_STEPS, VEOMNI_SERVE_PREFIX_CACHE,
VEOMNI_SERVE_PREFILL_CHUNK, VEOMNI_SERVE_SPEC_K, VEOMNI_SERVE_SPEC_DRAFT,
VEOMNI_SERVE_QUEUE_BOUND, VEOMNI_SERVE_CLASSES, VEOMNI_SERVE_TENANT_INFLIGHT,
VEOMNI_SERVE_KV_QUANT, VEOMNI_SERVE_WEIGHT_QUANT, VEOMNI_SERVE_REPLICAS,
VEOMNI_SERVE_PUBLISH_FROM, VEOMNI_SERVE_PUBLISH_VERSION,
VEOMNI_SERVE_PUBLISH_VERIFY, VEOMNI_SERVE_OUT (post-mortem dump dir, and
the router's heartbeat dir when set); the router's self-healing knobs
VEOMNI_SERVE_STALL_S (wedge deadline, default 60), VEOMNI_SERVE_MAX_RESPAWNS
(2), VEOMNI_SERVE_PROBATION (2) and VEOMNI_SERVE_MIN_LIVE (1).
VEOMNI_FAULT_PLAN arms the serving fault points (serve.admit /
serve.prefill / serve.decode_tick / serve.spawn / serve.publish).
VEOMNI_METRICS_PORT starts the Prometheus exporter
(``observability/exporter.py``; a negative port binds an ephemeral one):
``/metrics``, ``/healthz``, ``/debug/requests``, ``/debug/memory`` (with the
KV pool's capacity), ``/debug/cost`` (while the exporter runs, the
engine counts each new bucket's first call in the process into the cost
census; without it, serving pays no counting pass) and, under ``--replicas``,
``/debug/router``. Its HTTP thread reads thread-safe snapshots only (registry
gauges, tracer snapshots, ``Router.health``/``debug_doc``), never the
scheduler state the pump mutates.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.utils.device import resolve_device

def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt-ids", action="append", default=[],
                    help="comma-separated token ids; repeatable")
    ap.add_argument("--synthetic", type=int, default=0, help="also enqueue N random prompts")
    ap.add_argument("--synthetic-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="",
                    help="train_text_step.bench_config preset (or HF_CONFIGS name, e.g. "
                         "gpt_oss_20b) instead of the tiny demo")
    ap.add_argument("--model-path", default="",
                    help="HF directory (config.json + safetensors) to serve instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=int(env("VEOMNI_SERVE_SLOTS", 4)))
    ap.add_argument("--block-size", type=int, default=int(env("VEOMNI_SERVE_BLOCK", 16)))
    ap.add_argument("--max-model-len", type=int, default=int(env("VEOMNI_SERVE_MAX_LEN", 2048)))
    ap.add_argument("--log-steps", type=int, default=int(env("VEOMNI_SERVE_LOG_STEPS", 0)))
    ap.add_argument("--prefix-cache", type=int, choices=(0, 1),
                    default=int(env("VEOMNI_SERVE_PREFIX_CACHE", 1)),
                    help="share prompt KV blocks across requests (0: exclusive blocks)")
    ap.add_argument("--prefill-chunk", type=int, default=int(env("VEOMNI_SERVE_PREFILL_CHUNK", 0)),
                    help="max tokens prefilled per engine tick (0 = whole prompt at once)")
    ap.add_argument("--spec-k", type=int, default=int(env("VEOMNI_SERVE_SPEC_K", 0)),
                    help="speculative decoding: max drafted tokens per slot per tick (0 = off)")
    ap.add_argument("--spec-draft", default=env("VEOMNI_SERVE_SPEC_DRAFT", "ngram"),
                    help="drafting strategy registry impl (`ngram`, `off`)")
    ap.add_argument("--kv-quant", choices=("none", "int8", "fp8"),
                    default=env("VEOMNI_SERVE_KV_QUANT", "none"),
                    help="KV block storage: dense or int8 blocks (fp8 raises)")
    ap.add_argument("--weight-quant", choices=("none", "int8"),
                    default=env("VEOMNI_SERVE_WEIGHT_QUANT", "none"),
                    help="decode weight storage: dense or int8 projections")
    ap.add_argument("--queue-bound", type=int, default=int(env("VEOMNI_SERVE_QUEUE_BOUND", 0)),
                    help="max waiting requests before submissions are load-shed (0 = unbounded)")
    ap.add_argument("--classes", default=env("VEOMNI_SERVE_CLASSES", "interactive:4,batch:1"),
                    help="QoS classes 'name:weight,...', highest priority first")
    ap.add_argument("--tenant-inflight", type=int,
                    default=int(env("VEOMNI_SERVE_TENANT_INFLIGHT", 0)),
                    help="per-tenant waiting+running cap (0 = uncapped)")
    ap.add_argument("--replicas", type=int, default=int(env("VEOMNI_SERVE_REPLICAS", 1)),
                    help="N > 1 serves through the router over N engine replicas "
                         "(prefix-affinity dispatch, QoS at the router); 1 = bare engine")
    ap.add_argument("--priority", default="interactive", help="QoS class for CLI-built requests")
    ap.add_argument("--tenant", default="", help="tenant id for CLI-built requests")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="end-to-end deadline for CLI-built requests (0 = none)")
    ap.add_argument("--requests-json", default="",
                    help="JSON list of request objects; '-' reads stdin")
    ap.add_argument("--publish-from", default=env("VEOMNI_SERVE_PUBLISH_FROM", ""),
                    help="checkpoint step dir (global_step_N) to hot-publish: integrity-gated "
                         "load, then a rolling swap mid-serve (router) or a pre-serve swap "
                         "(bare engine)")
    ap.add_argument("--publish-version", default=env("VEOMNI_SERVE_PUBLISH_VERSION", ""),
                    help="version tag of the published weights (default: the step dir's name)")
    ap.add_argument("--publish-verify", choices=("off", "size", "full"),
                    default=env("VEOMNI_SERVE_PUBLISH_VERIFY", "size"),
                    help="manifest verification of --publish-from (a corrupt generation is "
                         "refused before a byte is loaded)")
    return ap


def start_exporter(router, engine):
    """``VEOMNI_METRICS_PORT``'s exporter for the pump (``scripts/serve.py:
    332-381``), or None when the knob is unset. The health document reads
    registry gauges and counters (or ``Router.health``), which the pump
    publishes after each tick."""
    from veomni_tpu_torch.observability.exporter import maybe_start_from_env
    from veomni_tpu_torch.observability.metrics import get_registry

    if router is not None:
        tracers = [h.engine.tracer for h in router.replicas.values()]

        def requests_fn():
            doc = {"inflight": [], "finished": []}
            for t in tracers:
                snap = t.snapshot()
                doc["inflight"].extend(snap.get("inflight", ()))
                doc["finished"].extend(snap.get("finished", ()))
            return doc

        def health_fn():
            # healthy flips False (a 503) while the live count sits under
            # min_live, and back once respawned replicas clear probation
            doc = router.health()
            reg = get_registry()
            doc["rejected"] = reg.counter("serve.router.rejected").value
            doc["deadline_cancelled"] = reg.counter("serve.router.deadline_cancelled").value
            return doc

        return maybe_start_from_env(health_fn=health_fn, requests_fn=requests_fn,
                                    memory_fn=engine.kv_capacity, router_fn=router.debug_doc)

    def health_fn():
        reg = get_registry()
        return {"healthy": True,
                "queue_depth": reg.gauge("serve.queue_depth").value,
                "num_running": reg.gauge("serve.num_running").value,
                "rejected": reg.counter("serve.rejected").value,
                "deadline_misses": reg.counter("serve.deadline_misses").value}

    return maybe_start_from_env(health_fn=health_fn, requests_fn=engine.tracer.snapshot,
                                memory_fn=engine.kv_capacity)


def router_config(args):
    """The router's knobs: ``--replicas`` and the self-healing env knobs
    (wedge deadline, respawn budget, probation, live floor); heartbeats
    only where the operator chose an output dir (``VEOMNI_SERVE_OUT``)."""
    from veomni_tpu_torch.serving import RouterConfig

    env = os.environ.get
    return RouterConfig(
        replicas=args.replicas, replica_stall_s=float(env("VEOMNI_SERVE_STALL_S", 60.0)),
        max_respawns=int(env("VEOMNI_SERVE_MAX_RESPAWNS", 2)),
        probation_requests=int(env("VEOMNI_SERVE_PROBATION", 2)),
        min_live=int(env("VEOMNI_SERVE_MIN_LIVE", 1)), heartbeat_dir=env("VEOMNI_SERVE_OUT", ""))


def build_model(args, device: torch.device):
    """The ``--model-path`` HF directory's model, else the ``--preset``
    model (or the tiny demo) with random weights from ``--seed``."""
    if args.model_path:
        from veomni_tpu_torch.models.auto import build_foundation_model

        fm = build_foundation_model(args.model_path, weights_path=args.model_path,
                                    device=device, param_dtype="bfloat16")
        return fm.module, fm.config
    if args.preset:
        from veomni_tpu_torch.train_text_step import bench_config

        # serving holds no f32 master copy: the weights are made in the
        # compute dtype (Qwen3-30B-A3B's 30.5 B parameters fit one card so)
        cfg = bench_config(preset=args.preset, param_dtype="bfloat16")
    else:  # tiny random demo model
        cfg = TransformerConfig(
            model_type="qwen3", vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            qk_norm=True, dtype=torch.float32,
        )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return Transformer(cfg, gen, device=device), cfg


def build_requests(args, cfg, ap):
    from veomni_tpu_torch.serving import Request, SamplingParams

    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                              max_new_tokens=args.max_new, eos_id=args.eos_id, seed=args.seed)
    cli_deadline = args.deadline_s if args.deadline_s > 0 else None
    prompts = [[int(t) for t in s.split(",")] for s in args.prompt_ids]
    rng = np.random.default_rng(args.seed)
    prompts += [[int(t) for t in rng.integers(1, cfg.vocab_size, args.synthetic_len)]
                for _ in range(args.synthetic)]
    reqs = [Request(prompt_ids=p, sampling=sampling, priority=args.priority, tenant=args.tenant,
                    deadline_s=cli_deadline) for p in prompts]
    if args.requests_json:
        if args.requests_json == "-":
            docs = json.load(sys.stdin)
        else:
            with open(args.requests_json) as f:
                docs = json.load(f)
        for d in docs:
            # absent falls back to the CLI default; <= 0 means no deadline
            if d.get("deadline_s") is None:
                dl = cli_deadline
            else:
                dl = float(d["deadline_s"])
                dl = dl if dl > 0 else None
            reqs.append(Request(
                prompt_ids=[int(t) for t in d["prompt_ids"]],
                sampling=SamplingParams(
                    temperature=float(d.get("temperature", args.temperature)),
                    top_k=int(d.get("top_k", args.top_k)),
                    top_p=float(d.get("top_p", args.top_p)),
                    max_new_tokens=int(d.get("max_new_tokens", args.max_new)),
                    eos_id=int(d.get("eos_id", args.eos_id)),
                    seed=int(d.get("seed", args.seed)),
                ),
                request_id=str(d.get("request_id", "")),
                priority=str(d.get("priority", args.priority)),
                tenant=str(d.get("tenant", args.tenant)),
                deadline_s=dl,
            ))
    if not reqs:
        ap.error("nothing to do: pass --prompt-ids, --synthetic N and/or --requests-json")
    return reqs


def main(argv: Optional[List[str]] = None):
    """Serve as the command line (or ``argv``) says; returns the outputs."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    device = resolve_device(args.device)

    from veomni_tpu_torch.observability.flight_recorder import (
        configure_flight_recorder,
        dump_postmortem,
    )
    from veomni_tpu_torch.resilience.faults import arm_from_env
    from veomni_tpu_torch.resilience.integrity import CheckpointCorruptError
    from veomni_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        Router,
        load_published_params,
    )

    arm_from_env()
    model, cfg = build_model(args, device)
    ecfg = EngineConfig(
        num_slots=args.slots, block_size=args.block_size, max_model_len=args.max_model_len,
        log_every_steps=args.log_steps, prefix_cache=bool(args.prefix_cache),
        prefill_chunk=args.prefill_chunk, spec_k=args.spec_k, spec_draft=args.spec_draft,
        classes=args.classes, queue_bound=args.queue_bound,
        tenant_max_inflight=args.tenant_inflight, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant,
    )
    router = None
    if args.replicas > 1:
        router = Router(model, cfg, ecfg, router_config(args), device=device)
        del model  # the router keeps its payload on the host
        # every replica's pool is alike: the first describes them
        engine = next(iter(router.replicas.values())).engine
        server = router
    else:
        engine = server = InferenceEngine(model, cfg, ecfg, device=device)
    cap = engine.kv_capacity()
    print(json.dumps({
        "kv_quant": args.kv_quant, "weight_quant": args.weight_quant,
        "replicas": args.replicas, "kv_pool_bytes": cap["pool_bytes"],
        "kv_block_bytes": cap["block_bytes"],
        "kv_max_concurrent_seqs": cap["max_concurrent_seqs"],
    }), flush=True)
    # --publish-from: through the integrity gate before a token is served,
    # so a corrupt or uncommitted generation fails here, not mid-serve. The
    # router rolls it in after the first token; the bare engine (which
    # refuses swaps while busy) swaps it now.
    publish_params, publish_version = None, ""
    if args.publish_from:
        try:
            publish_params = load_published_params(args.publish_from,
                                                   verify_mode=args.publish_verify)
        except CheckpointCorruptError as e:
            raise SystemExit(f"--publish-from refused by integrity gate: {e}")
        publish_version = args.publish_version or os.path.basename(
            os.path.normpath(args.publish_from))
        if router is None:
            info = engine.swap_weights(publish_params)
            print(json.dumps({"publish": publish_version, "mode": "pre-serve", **info}),
                  flush=True)
            publish_params = None
    # post-mortems land somewhere deliberate, not whatever CWD the operator
    # launched from
    configure_flight_recorder(dump_dir=os.environ.get("VEOMNI_SERVE_OUT", "."))
    reqs = build_requests(args, cfg, ap)
    exporter = start_exporter(router, engine)
    try:
        for ev in server.generate(reqs):
            line = {"request_id": ev.request_id, "index": ev.index, "token": ev.token}
            if ev.finished:
                line["finished"] = ev.finish_reason
            print(json.dumps(line), flush=True)
            if publish_params is not None:
                # the first token landed: roll the published weights into the
                # running fleet (in-flight requests finish on the old version)
                router.publish_weights(publish_params, publish_version)
                print(json.dumps({"publish": publish_version, "mode": "rolling"}), flush=True)
                publish_params = None
        outs = server.run()  # no-op drain; collects final outputs
    except BaseException as e:
        # a pump that dies mid-decode leaves its request/event history in a
        # post-mortem; an allocator failure also the buffer and cost censuses
        from veomni_tpu_torch.observability.devmem import attach_oom_extra

        dump_postmortem(f"exception:{type(e).__name__}",
                        extra=attach_oom_extra(e, {"error": str(e)[:2000]}))
        raise
    finally:
        if exporter is not None:
            exporter.stop()
    print(json.dumps({"metrics": server.metrics()}), flush=True)
    # terminal-status census: shed/expired requests are reported distinctly
    by_status = {"ok": 0, "rejected": 0, "deadline": 0, "cancelled": 0}
    for o in outs.values():
        by_status[o.finish_reason if o.finish_reason in by_status else "ok"] += 1
    census = {
        "completed": by_status["ok"],
        "rejected": by_status["rejected"],
        "deadline_cancelled": by_status["deadline"],
        "cancelled": by_status["cancelled"],
        "deadline_missed": sum(1 for o in outs.values() if o.deadline_missed),
    }
    if router is not None:
        # where the traffic landed: each replica's dispatch counts and state
        census["replicas"] = [h.status_doc() for h in router.replicas.values()]
        census["replicas_retired"] = [h.status_doc() for h in router.retired]
    print(json.dumps(census), flush=True)
    for rid in sorted(outs):
        o = outs[rid]
        line = {
            "request_id": rid, "tokens": o.token_ids, "finish_reason": o.finish_reason,
            "ttft_s": round(o.ttft_s, 4) if o.ttft_s is not None else None,
            "cached_tokens": o.cached_tokens,
            "spec_accepted_tokens": o.spec_accepted_tokens,
            "kv_quant": args.kv_quant, "weight_quant": args.weight_quant,
        }
        if o.deadline_missed:
            line["deadline_missed"] = True
        print(json.dumps(line), flush=True)
    return outs


if __name__ == "__main__":
    main()
