"""The trainer at Qwen3-0.6B on the card: where its step time goes.

Writes a seeded pretokenized corpus and a YAML config for
``veomni_tpu_torch.tasks.train_text`` (Qwen3-0.6B at full width and depth,
seq 4096 x micro-batch 4, bf16 compute over f32 master weights, ``ctx``
remat, AdamW lr 1e-4 cosine) into a temporary directory, then runs, in
turns on one card: ``train_text_step``'s bare step loop, the trainer with
``enable_full_determinism`` on, off, off, on, and the bare loop again, six
steps each from the same seed, and prints each leg's warm step times (steps
2-6). Then two more trainer runs, with ``enable_full_determinism`` on and
off, trace step 5 with ``torch.profiler`` (``enable_profiling``) and print
its device time by kernel category
(``train_text_step.kernel_time_breakdown``). Run from the repository root
on a machine with one NVIDIA Hopper card::

    python3 -m veomni_tpu_torch.tools.trainer_profile [--trace-dir DIR]

The last line is one JSON object with every time. ``chip_smoke.py``'s
trainer phase uses the same corpus and config (``write_config``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

TRAINER_YAML = """
model:
  config_overrides:
    model_type: qwen3
    vocab_size: 151936
    hidden_size: 1024
    intermediate_size: 3072
    num_hidden_layers: 28
    num_attention_heads: 16
    num_key_value_heads: 8
    head_dim: 128
    qk_norm: true
    tie_word_embeddings: true
    max_position_embeddings: 131072
    rope_theta: 1000000.0
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: 4096
train:
  micro_batch_size: 4
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  enable_full_determinism: true
  seed: {seed}
  save_hf_weights: false
  prefetch_depth: 0
  log_steps: 1
"""
STEPS = 6
SEED = 0  # train.seed: the same initial weights as train_text_step's SEED


def write_corpus(path: str, rows: int = 512, vocab: int = 151936) -> int:
    """Seeded pretokenized jsonl: tokens uniform over the vocabulary,
    document lengths uniform in [256, 2048] (``packed_batches``' law at
    seq 4096). Returns the token count."""
    rng = np.random.default_rng(1)
    total = 0
    with open(path, "w") as f:
        for _ in range(rows):
            n = int(rng.integers(256, 2049))
            total += n
            f.write(json.dumps({"input_ids": rng.integers(0, vocab, n).tolist()}) + "\n")
    return total


def write_config(tmp: str, steps: int = STEPS, seed: int = SEED) -> str:
    """Corpus and YAML under ``tmp``; returns the YAML's path."""
    data = os.path.join(tmp, "data.jsonl")
    write_corpus(data)
    path = os.path.join(tmp, "qwen3_0p6b.yaml")
    with open(path, "w") as f:
        f.write(TRAINER_YAML.format(data=data, steps=steps, seed=seed))
    return path


def trainer_leg(cfg_path: str, out_dir: str, *overrides: str, keep_trace: str = ""):
    """Warm step times (ms, steps 2..STEPS) of one trainer run; with
    ``keep_trace``, its profiler trace is copied there before the run's
    output directory is removed."""
    import torch

    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Clock(Callback):
        def __init__(self):
            self.t = []

        def on_step_end(self, trainer, state):
            self.t.append(time.perf_counter())

    trainer = TextTrainer(parse_args(VeOmniArguments,
                                     [cfg_path, f"--train.output_dir={out_dir}", *overrides]))
    clock = Clock()
    trainer.callbacks.append(clock)
    trainer.train()
    trainer.checkpointer.close()
    del trainer
    destroy_parallel_state()
    torch.use_deterministic_algorithms(False)
    if keep_trace:
        shutil.copy(os.path.join(out_dir, "profile_trace", "trace_rank0.json.gz"), keep_trace)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return [(b - a) * 1e3 for a, b in zip(clock.t, clock.t[1:])]


def bare_leg():
    """Warm step times of ``train_text_step``'s loop on its own batches."""
    import torch

    from veomni_tpu_torch.train_text_step import run_train_steps

    records = run_train_steps(4096, 4, STEPS, device="cuda")
    torch.cuda.empty_cache()
    return [r["step_ms"] for r in records[1:]]


def median(xs):
    return sorted(xs)[len(xs) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profiled steps' chrome traces here")
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("trainer_profile: no CUDA device", file=sys.stderr)
        return 1
    from veomni_tpu_torch.train_text_step import kernel_time_breakdown

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="trainer_profile_")
    try:
        cfg = write_config(tmp)
        legs = []
        for name in ("bare", "deterministic", "default", "default", "deterministic", "bare"):
            if name == "bare":
                ms = bare_leg()
            else:
                flag = "true" if name == "deterministic" else "false"
                ms = trainer_leg(cfg, os.path.join(tmp, "out"),
                                 f"--train.enable_full_determinism={flag}")
            legs.append({"leg": name, "step_ms": ms, "median_ms": median(ms)})
            print(f"{name}: warm steps {', '.join(f'{x:.1f}' for x in ms)} ms, median "
                  f"{median(ms):.1f} [{card}]", flush=True)
        profiled = {}
        for name, flag in (("deterministic", "true"), ("default", "false")):
            trace = os.path.join(tmp, f"trace_{name}.json.gz")
            trainer_leg(cfg, os.path.join(tmp, "prof"), "--train.enable_profiling=true",
                        "--train.profile_start_step=4", "--train.profile_end_step=5",
                        f"--train.enable_full_determinism={flag}", keep_trace=trace)
            profiled[name] = breakdown = kernel_time_breakdown(trace)
            print(f"profiled trainer step 5 ({name}): device ms by category "
                  f"{json.dumps(breakdown)}; busy {breakdown['total'] / breakdown['span']:.3f} "
                  f"of the kernel span [{card}]", flush=True)
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
                shutil.copy(trace, args.trace_dir)
        print(json.dumps({"card": card, "legs": legs, "profiled_step_ms": profiled}), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
