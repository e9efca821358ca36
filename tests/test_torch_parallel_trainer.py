"""The port's trainer across processes (``trainer/base.py``'s distributed
init, dp-sharded data, the plan, ``checkpoint/checkpointer.py`` across
ranks) on the CPU: the counterpart of ``tests/test_multihost.py``.

One world of 2 gloo ranks (``parallel/launch.py::run_ranks``) runs, in turn:
* a straight 4-step run (FSDP 2, checkpoint at 2), a preempted one (stops
  after its save at 2) and its restart, which resumes and runs to 4: the
  restart's losses and final parameters are bit-identical to the straight
  run's; both ranks report the same losses, each its own dp slice;
* the straight run against the same run at world size 1 (the reference
  test's layout: a dataset of one global batch, so each step sees the same
  rows): losses within rtol 2e-4, grad norms within 2e-4;
* a world-1 checkpoint restored at world 2 and a world-2 one at world 1
  (``ckpt_elastic``): the continued steps within rtol 2e-4 of the port's own
  straight runs (the reference's cross-mesh resume test fails, so the
  port's straight run is the oracle, not the JAX package);
* ulysses 2 (both ranks read the same rows; and with ``train.ulysses_async``,
  the toy's head layout clamping its chunks to 1), the MoE at ep 2, Muon and
  Adafactor (whole leaves gathered), the numerics sibling step, each
  against world 1 within rtol 2e-4;
* the DPO trainer (its reference policy a whole copy on each rank) at
  FSDP 2 and at ulysses 2, where each row's log-prob sum is summed over its
  sequence chunks; the HF export of the MoE run at ep 2 (rank 0 writes
  the gathered model) against the world-1 run's; LoRA on the MoE at ep 2
  (the adapters replicated but for the expert ones' ep slice);
* the Qwen2.5-VL trainer on per-row patch budgets against the packed
  world-1 run (the reference's two-process VLM test, rtol 2e-4), at FSDP 2
  and at ulysses 2, where the text layers split the sequence and the tower
  runs without sequence parallelism (``tests/test_heterogeneous_sp.py``).
And ``configs/text/qwen3_toy_cpu.yaml`` (4 virtual devices, ulysses 2)
trains 2 steps through ``python -m veomni_tpu_torch.tasks.train_text``,
which starts 4 CPU ranks over gloo; and an HF checkpoint loaded at ep 2
reads on each rank the expert tensors of its experts alone.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from veomni_tpu_torch.parallel.launch import run_ranks

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_parallel_fixtures import trainer_world

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ENV = {"PYTHONPATH": os.pathsep.join([TESTS, REPO])}
TOY = {"model_type": "qwen3", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
       "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
       "head_dim": 16, "qk_norm": True}
MOE = dict(TOY, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64)
VLM = {"model_type": "qwen2_5_vl", "vocab_size": 256, "hidden_size": 64,
       "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]},
       "image_token_id": 9, "video_token_id": 10, "vision_start_token_id": 8,
       "vision": {"depth": 2, "hidden_size": 32, "intermediate_size": 64, "num_heads": 2,
                  "patch_size": 2, "spatial_merge_size": 2, "window_size": 8,
                  "fullatt_block_indexes": [1], "out_hidden_size": 64}}
RTOL = 2e-4


def write_data(path, rows=4, seq=64, seed=0):
    """``rows`` samples of exactly ``seq`` tokens: each fills a packed row."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps({"input_ids": rng.integers(0, 256, seq).tolist()}) + "\n")


def write_pairs(path, rows=2, seed=0):
    """DPO rows (``tests/test_torch_dpo.py::write_pairs``)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            row = {"prompt": rng.integers(0, 256, int(rng.integers(4, 13))).tolist()}
            for side in ("chosen", "rejected"):
                row[side] = rng.integers(0, 256, int(rng.integers(8, 41))).tolist()
            f.write(json.dumps(row) + "\n")


def read_export(out_dir):
    """{tensor name: array} of a run's HF export."""
    from safetensors.numpy import load_file

    tensors = {}
    for name in sorted(os.listdir(os.path.join(out_dir, "hf_ckpt"))):
        if name.endswith(".safetensors"):
            tensors.update(load_file(os.path.join(out_dir, "hf_ckpt", name)))
    return tensors


def write_vlm_data(path, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            f.write(json.dumps({
                "input_ids": rng.integers(11, 256, int(rng.integers(8, 24))).tolist(),
                "images": [rng.random((8 + 4 * (i % 2), 8, 3)).tolist()]}) + "\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, each once: {name: record}; world-1 runs in this process,
    the world-2 ones in one world of 2 ranks."""
    tmp = tmp_path_factory.mktemp("trainer")
    data, vlm_data, pairs = (str(tmp / "data.jsonl"), str(tmp / "vlm.jsonl"),
                             str(tmp / "pairs.jsonl"))
    write_data(data)
    write_vlm_data(vlm_data)
    write_pairs(pairs)

    def run(name, model=TOY, **train):
        return {"model": model, "data": data, "out": str(tmp / name), "train": train}

    def vlm_run(name, **train):
        return {"model": VLM, "data": vlm_data, "out": str(tmp / name), "trainer": "vlm",
                "data_args": {"max_patches": 128}, "train": train}

    def dpo_run(name, **train):
        return {"model": TOY, "data": pairs, "out": str(tmp / name), "trainer": "dpo",
                "data_type": "dpo", "train": {"lr": 1e-2, **train}}

    w1_first = dict(run("w1to2", train_steps=4, save_steps=2, micro_batch_size=4), stop_at=2)
    one = trainer_world(0, 1, {"runs": {
        "straight": run("w1", train_steps=4, micro_batch_size=4),
        "first": w1_first,
        "u2": run("w1u2", train_steps=2),
        "moe_ep2": run("w1moe", MOE, train_steps=3, micro_batch_size=4, save_hf_weights=True),
        "dpo": dpo_run("w1dpo", train_steps=3, micro_batch_size=2),
        "lora_moe_ep2": dict(run("w1lora", MOE, train_steps=3, micro_batch_size=4, lr=1e-2),
                             model_args={"lora": {"rank": 4}}),
        "muon": run("w1muon", train_steps=3, optimizer="muon", micro_batch_size=4),
        "adafactor": run("w1ada", train_steps=3, optimizer="adafactor", micro_batch_size=4),
        "numerics": run("w1num", train_steps=3, observability_numerics_interval=2,
                        micro_batch_size=4),
        "vlm": vlm_run("w1vlm", train_steps=3, micro_batch_size=2),
    }})
    ranks = run_ranks(2, "torch_parallel_fixtures:trainer_world", {"runs": {
        "straight": run("w2", train_steps=4, save_steps=2),
        "first": dict(run("w2resume", train_steps=4, save_steps=2), stop_at=2),
        "second": run("w2resume", train_steps=4, save_steps=2),
        "from_w1": run("w1to2", train_steps=4, save_steps=2, ckpt_elastic=True),
        "u2": run("w2u2", train_steps=2, ulysses_parallel_size=2),
        "u2_async": run("w2u2async", train_steps=2, ulysses_parallel_size=2,
                        ulysses_async=True),
        "moe_ep2": run("w2moe", MOE, train_steps=3, expert_parallel_size=2,
                       save_hf_weights=True),
        "dpo": dpo_run("w2dpo", train_steps=3, micro_batch_size=1),
        "lora_moe_ep2": dict(run("w2lora", MOE, train_steps=3, expert_parallel_size=2, lr=1e-2),
                             model_args={"lora": {"rank": 4}}),
        "dpo_u2": dpo_run("w2dpou2", train_steps=3, micro_batch_size=2,
                          ulysses_parallel_size=2),
        "muon": run("w2muon", train_steps=3, optimizer="muon"),
        "adafactor": run("w2ada", train_steps=3, optimizer="adafactor"),
        "numerics": run("w2num", train_steps=3, observability_numerics_interval=2),
        "vlm": vlm_run("w2vlm", train_steps=3, micro_batch_size=1),
        "vlm_u2": vlm_run("w2vlmu2", train_steps=3, micro_batch_size=2,
                          ulysses_parallel_size=2),
    }}, env=ENV, timeout=600)
    # the world-2 checkpoint of step 2, alone, restored at world 1
    src = tmp / "w2resume" / "checkpoints" / "global_step_2"
    shutil.copytree(src, tmp / "w2to1" / "checkpoints" / "global_step_2")
    back = trainer_world(0, 1, {"runs": {"from_w2": run(
        "w2to1", train_steps=4, save_steps=2, micro_batch_size=4, ckpt_elastic=True)}})
    return {"w1": one, "w2": ranks, "back": back, "tmp": tmp}


def test_ranks_agree_and_load_their_dp_slices(runs):
    r0, r1 = runs["w2"]
    for name in r0:
        assert r0[name]["losses"] == r1[name]["losses"], name
        assert r0[name]["world"] == r1[name]["world"] == 2
    # FSDP 2: two dp slices; ulysses 2: one dp slice, both ranks read it
    assert (r0["straight"]["dp_rank"], r1["straight"]["dp_rank"]) == (0, 1)
    assert r0["straight"]["dp_size"] == r1["straight"]["dp_size"] == 2
    assert (r0["u2"]["dp_rank"], r1["u2"]["dp_rank"], r0["u2"]["dp_size"]) == (0, 0, 1)
    assert (r0["moe_ep2"]["dp_rank"], r1["moe_ep2"]["dp_rank"]) == (0, 1)


def test_resume_is_bit_identical_to_the_straight_run(runs):
    for rank in runs["w2"]:
        straight, first, second = rank["straight"], rank["first"], rank["second"]
        assert first["losses"] == straight["losses"][:2]
        assert second["first_step"] == 2
        assert second["losses"] == straight["losses"][2:]
        assert second["grad_norms"] == straight["grad_norms"][2:]
        assert second["digest"] == straight["digest"]  # this rank's shards, bit for bit


@pytest.mark.parametrize("name", ["straight", "u2", "u2_async", "moe_ep2", "muon", "adafactor",
                                  "numerics", "vlm", "vlm_u2", "dpo", "dpo_u2", "lora_moe_ep2"])
def test_world2_trains_as_world1(runs, name):
    want = {"u2_async": "u2", "vlm_u2": "vlm", "dpo_u2": "dpo"}.get(name, name)
    got, want = runs["w2"][0][name], runs["w1"][want]
    assert len(got["losses"]) == len(want["losses"]) > 0
    assert got["consumed_tokens"] == want["consumed_tokens"]  # the meter counts the mesh's
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=RTOL)


def test_the_hf_export_gathers_the_whole_model(runs):
    """Rank 0 writes the export of the whole model (FSDP2 shards and each
    rank's experts gathered): the world-1 run's tensors, names and shapes,
    values within the steps' rounding."""
    got = read_export(str(runs["tmp"] / "w2moe"))
    want = read_export(str(runs["tmp"] / "w1moe"))
    assert sorted(got) == sorted(want) and want
    for name, value in want.items():
        assert got[name].shape == value.shape, name
        np.testing.assert_allclose(got[name], value, rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("direction", ["world1_to_world2", "world2_to_world1"])
def test_a_checkpoint_restores_at_the_other_world_size(runs, direction):
    if direction == "world1_to_world2":
        got, straight = runs["w2"][0]["from_w1"], runs["w1"]["straight"]
    else:
        got, straight = runs["back"]["from_w2"], runs["w2"][0]["straight"]
    assert got["first_step"] == 2
    np.testing.assert_allclose(got["losses"], straight["losses"][2:], rtol=RTOL)
    np.testing.assert_allclose(got["grad_norms"], straight["grad_norms"][2:], rtol=RTOL)


def test_qwen3_toy_cpu_yaml_trains_on_four_cpu_ranks(tmp_path):
    """The shipped config as it is (``num_virtual_devices: 4``, ulysses 2),
    its steps cut to 2: the entry point starts 4 CPU ranks over gloo."""
    write_data(tmp_path / "data.jsonl", rows=64, seq=300)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "VEOMNI_LOG_LEVEL": "INFO"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "veomni_tpu_torch.tasks.train_text",
         os.path.join(REPO, "configs", "text", "qwen3_toy_cpu.yaml"), "--train.train_steps=2",
         f"--data.train_path={tmp_path / 'data.jsonl'}",
         f"--train.output_dir={tmp_path / 'out'}", "--train.save_hf_weights=false"],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "starting 4 CPU ranks over gloo" in out
    assert out.count("joins tcp://localhost") == 4 and "over gloo on cpu" in out
    for rank in range(4):  # each rank its own metrics file, the loss global
        with open(tmp_path / "out" / f"metrics_rank{rank}.jsonl") as f:
            lines = [json.loads(x) for x in f if x.strip()]
        assert lines and all(np.isfinite(line["loss"]) for line in lines)
    step = tmp_path / "out" / "checkpoints" / "global_step_2"
    assert (step / "train_state" / "model.pt").exists()  # rank 0's gathered payload
    assert sorted(p.name for p in step.glob("extra_state_rank*.json")) == [
        f"extra_state_rank{r}.json" for r in range(4)]  # each rank's cursor


def test_each_ep_rank_reads_only_its_experts(tmp_path):
    """``tests/test_multihost.py::test_two_process_ep_sliced_weight_load``: an
    HF checkpoint loaded at ep 2 (each rank its own process): a rank reads
    the expert tensors of its own experts and no other's, and every row it
    holds equals the tensor on disk bit for bit."""
    import torch

    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.hf_io import save_hf_checkpoint

    cfg = TransformerConfig(**MOE, dtype=torch.float32)
    save_hf_checkpoint(Transformer(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                       str(tmp_path / "hf"))
    write_data(tmp_path / "data.jsonl")
    ranks = run_ranks(2, "torch_parallel_fixtures:ep_load_world",
                      {"ckpt": str(tmp_path / "hf"), "data": str(tmp_path / "data.jsonl"),
                       "out": str(tmp_path / "out")}, env=ENV, timeout=300)
    n_experts = MOE["num_experts"]
    for r in ranks:
        assert r["match"], r
        mine = set(range(*r["experts"]))
        experts_read = {int(name.split(".experts.")[1].split(".")[0])
                        for name in r["read"] if ".experts." in name}
        assert experts_read == mine and len(mine) == n_experts // 2, (r["experts"], experts_read)
        # the dense weights are read whole on each rank
        assert any("self_attn.q_proj" in name for name in r["read"])
