"""Import and device hygiene of the PyTorch port.

* ``veomni_tpu_torch`` and ``chip_smoke.py`` import neither JAX (nor optax,
  flax) nor anything of ``veomni_tpu``, nor ``safetensors`` or
  ``transformers``: checked statically over every source file, and
  dynamically by importing every module in a fresh subprocess.
* Entry points called without ``device=`` (the trainer and
  ``tasks/train_text.py``, and the post-training entry points
  ``tasks/train_text_{dpo,distill,rl}.py`` and ``tasks/infer_text.py``,
  without ``train.platform: cpu``, the serving engine, the router and
  ``tasks/serve.py`` (bare and with ``--replicas 2``) without ``--device
  cpu``) on a machine
  without CUDA raise instead of running on the CPU; ``chip_smoke.py``
  exits non-zero and prints no result there, and also when it stands alone
  without the package.
"""

import ast
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "veomni_tpu_torch")
# the JAX stack and the reference package; and the HF packages, which the
# card's machine does not have (the port reads and writes safetensors itself)
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "orbax", "veomni_tpu", "safetensors",
             "transformers")


def _run(code_or_args, cwd=REPO, hide_cuda=True):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if hide_cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_forbidden_imports_in_sources():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_WALK = r"""
import importlib, pkgutil, sys
import veomni_tpu_torch
names = [m.name for m in pkgutil.walk_packages(veomni_tpu_torch.__path__, "veomni_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(len(names), leaked)
assert not leaked, leaked
""" % (FORBIDDEN,)


def test_every_module_imports_without_jax():
    proc = _run(_WALK)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 60, proc.stdout
    for name in PORTED_HOST_MODULES:
        assert os.path.exists(os.path.join(PKG, *name.split("."))
                              + ".py"), name


# the trainer path's host modules: each must import without JAX (the walk
# above imports every module of the package; this list pins that they exist)
PORTED_HOST_MODULES = (
    "utils.registry", "utils.helper", "utils.determinism", "observability.metrics",
    "observability.spans", "observability.flight_recorder", "observability.goodput",
    "observability.callback", "resilience.faults", "resilience.retry", "resilience.integrity",
    "resilience.elastic", "resilience.supervisor", "data.dataset", "data.data_transform",
    "data.data_loader", "arguments.arguments_types", "arguments.parser", "arguments.compat",
    "parallel.parallel_state", "models.auto", "checkpoint.checkpointer", "trainer.callbacks",
    "trainer.base", "trainer.text_trainer", "tasks.train_text", "models.hf_io",
    "data.dynamic_batching", "data.prefetch", "data.streaming",
    # the serving slice
    "ops.quantization", "ops.paged_attention", "ops.threefry", "models.decode",
    "observability.request_trace", "serving.api", "serving.kv_block_manager",
    "serving.prefix_cache", "serving.scheduler", "serving.spec_decode", "serving.engine",
    "tasks.serve",
    # the post-training slice: the trainers, their entry points and the
    # trainer's remaining callbacks' modules
    "trainer.dpo_trainer", "trainer.distill_trainer", "trainer.rl_trainer",
    "tasks.train_text_dpo", "tasks.train_text_distill", "tasks.train_text_rl",
    "train.channel_loss", "utils.moe_monitor",
    # the rest of the serving slice: the quality gate, weight publication,
    # the replica router, heartbeats and infer_text
    "serving.quality", "serving.weights", "serving.replica", "serving.router",
    "observability.fleet", "tasks.infer_text",
    # slice E: the optimizers, the numerics observatory, the cost census,
    # device-memory accounting, the exporter and the chaos soak
    "optim.muon", "optim.optimizer", "observability.numerics", "observability.cost",
    "observability.devmem", "observability.exporter", "resilience.chaos",
)


_NO_DEVICE = r"""
import torch
from veomni_tpu_torch.arguments import VeOmniArguments
from veomni_tpu_torch.models import Transformer
from veomni_tpu_torch.serving import InferenceEngine, Router
from veomni_tpu_torch.tasks import infer_text, serve
from veomni_tpu_torch.tasks.train_text import main
from veomni_tpu_torch.tasks import train_text_distill, train_text_dpo, train_text_rl
from veomni_tpu_torch.train_text_step import bench_config, run_train_steps
from veomni_tpu_torch.trainer import TextTrainer
from veomni_tpu_torch.utils.device import resolve_device
assert not torch.cuda.is_available()
cfg = bench_config(preset="qwen3_smoke")
args = VeOmniArguments()
args.train.save_hf_weights = False
args.train.prefetch_depth = 0
args.train.output_dir = %r
flags = ["--train.save_hf_weights=false", "--train.prefetch_depth=0",
         "--train.output_dir=" + args.train.output_dir]
for call in (lambda: resolve_device(),
             lambda: Transformer(bench_config(preset="qwen3_smoke"), torch.Generator()),
             lambda: run_train_steps(128, 1, 1, preset="qwen3_smoke"),
             lambda: TextTrainer(args),
             lambda: main(flags),
             lambda: train_text_dpo.main(flags),
             lambda: train_text_distill.main(flags),
             lambda: train_text_rl.main(flags),
             lambda: InferenceEngine(Transformer(cfg, torch.Generator(), device="cpu"), cfg),
             lambda: serve.main(["--synthetic", "1"]),
             lambda: Router(Transformer(cfg, torch.Generator(), device="cpu"), cfg),
             lambda: serve.main(["--synthetic", "1", "--replicas", "2"]),
             lambda: infer_text.main(["--model.config_overrides={\"model_type\": \"qwen3\"}"])):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("ran without a GPU and without device='cpu'")
print("ok")
"""


def test_entry_points_refuse_to_drop_to_cpu(tmp_path):
    proc = _run(_NO_DEVICE % str(tmp_path / "out"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0 and '"ok"' not in proc.stdout, proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    alone = _run(["chip_smoke.py"], cwd=str(tmp_path), hide_cuda=False)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout, alone.stdout
