"""HF safetensors checkpoint import and export for the port's text models.

Port of ``veomni_tpu/models/hf_io.py``: the key map (``_LAYER_MAP``,
``_EXPERT_MAP``), the lazy per-tensor reader (``LazyHFTensors``, ``:100``),
``hf_to_params`` (``:162``), ``params_to_hf`` (``:461``) and
``save_hf_checkpoint`` (``:539``, the same shard names and index JSON), for
the families the port builds: llama (rope scaling included), qwen2 (q/k/v
biases), qwen3, gemma3 (sandwich norms; its zero-centered norm weights are
stored as HF stores them), qwen3_moe (per-expert HF tensors stacked into
``experts.*`` [E, in, out]) and deepseek_v2/v3 (MLA's ``q_a``/``q_b``/
``kv_a``/``kv_b`` projections and norms, ``mlp.gate.e_score_correction_bias``,
``mlp.shared_experts.*``; HF numbers the leading dense layers and the MoE
layers after them in one sequence, as the port's layer list does, where
the reference maps them to its two stacked subtrees, ``:194``, ``:418``)
and gpt_oss (``self_attn.sinks``; ``mlp.router.weight``/``bias``; the
fused interleaved experts, ``:324-334``, ``:366-403``, ``:474-522``:
``mlp.experts.gate_up_proj`` [E, H, 2I] with gate in the even columns and
up in the odd ones, its bias ``gate_up_proj_bias`` [E, 2I] likewise, and
``down_proj`` [E, I, H] with ``down_proj_bias`` [E, H], none transposed).
The stride-2 split reads a layer's whole fused tensor once for both
halves, and the export interleaves a layer's gate and up as it writes it.
qwen3_vl_moe's text (``expert_layout: fused_chunked``, ``:336-357``,
``:489-497``) fuses its experts the same way but with gate and up as the two
halves of ``gate_up_proj``'s last dim, and reads its router from the
generic ``mlp.gate.weight``.

The card's machine has neither ``safetensors`` nor ``transformers``, so this
module reads and writes the safetensors format itself: an 8-byte
little-endian header length, a JSON header naming each tensor's dtype, shape
and ``data_offsets`` (relative to the end of the header), then the raw bytes.
It takes BF16, F16, F32, I64 and I32, and a sharded checkpoint's
``model.safetensors.index.json``.

PyTorch idiom: the port's model is an ``nn.Module`` whose parameters keep
the reference's names and ``[in, out]`` layout (one module per layer, where
the reference stacks layers), so ``hf_to_params`` fills a model's parameters
in place, one HF tensor at a time, on whatever device they live on: the host
holds one tensor at a time, never the whole model. A tensor goes to the
parameter's device as it is stored, and is cast and transposed there (on
the host, the cast and the transpose were most of a read's time).
``save_hf_checkpoint`` streams the same way: each tensor is laid out on
its device, copied off it and written from that copy.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# our parameter name in a decoder layer -> (hf suffix, transpose?): the
# reference's table for the families the port builds (HF torch linears are
# [out, in], ours [in, out])
_LAYER_MAP: Dict[str, Tuple[str, bool]] = {
    "input_layernorm": ("input_layernorm.weight", False),
    "q_proj": ("self_attn.q_proj.weight", True),
    "k_proj": ("self_attn.k_proj.weight", True),
    "v_proj": ("self_attn.v_proj.weight", True),
    "o_proj": ("self_attn.o_proj.weight", True),
    "q_bias": ("self_attn.q_proj.bias", False),
    "k_bias": ("self_attn.k_proj.bias", False),
    "v_bias": ("self_attn.v_proj.bias", False),
    "o_bias": ("self_attn.o_proj.bias", False),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    "sinks": ("self_attn.sinks", False),
    # MLA (deepseek)
    "q_a_proj": ("self_attn.q_a_proj.weight", True),
    "q_a_layernorm": ("self_attn.q_a_layernorm.weight", False),
    "q_b_proj": ("self_attn.q_b_proj.weight", True),
    "kv_a_proj_with_mqa": ("self_attn.kv_a_proj_with_mqa.weight", True),
    "kv_a_layernorm": ("self_attn.kv_a_layernorm.weight", False),
    "kv_b_proj": ("self_attn.kv_b_proj.weight", True),
    "post_attention_layernorm": ("post_attention_layernorm.weight", False),
    "pre_feedforward_layernorm": ("pre_feedforward_layernorm.weight", False),
    "post_feedforward_layernorm": ("post_feedforward_layernorm.weight", False),
    "gate_proj": ("mlp.gate_proj.weight", True),
    "up_proj": ("mlp.up_proj.weight", True),
    "down_proj": ("mlp.down_proj.weight", True),
    "gate_bias": ("mlp.gate_proj.bias", False),
    "up_bias": ("mlp.up_proj.bias", False),
    "down_bias": ("mlp.down_proj.bias", False),
    "router": ("mlp.gate.weight", True),
    "e_score_correction_bias": ("mlp.gate.e_score_correction_bias", False),
    # shared experts (deepseek)
    "shared_experts.gate_proj": ("mlp.shared_experts.gate_proj.weight", True),
    "shared_experts.up_proj": ("mlp.shared_experts.up_proj.weight", True),
    "shared_experts.down_proj": ("mlp.shared_experts.down_proj.weight", True),
}
# stacked experts [E, in, out] <- per-expert HF [out, in]
_EXPERT_MAP: Dict[str, str] = {
    "experts.gate_proj": "mlp.experts.{e}.gate_proj.weight",
    "experts.up_proj": "mlp.experts.{e}.up_proj.weight",
    "experts.down_proj": "mlp.experts.{e}.down_proj.weight",
}
# gpt_oss's MoE layer: our name -> (hf suffix, transpose?, the column
# parity of an interleaved gate/up tensor or None). Stacked [E, in, out]
# as ours, so nothing is transposed but the router ([E, H] in HF).
_FUSED_MAP: Dict[str, Tuple[str, bool, Optional[int]]] = {
    "router": ("mlp.router.weight", True, None),
    "router_bias": ("mlp.router.bias", False, None),
    "experts.gate_proj": ("mlp.experts.gate_up_proj", False, 0),
    "experts.up_proj": ("mlp.experts.gate_up_proj", False, 1),
    "experts.down_proj": ("mlp.experts.down_proj", False, None),
    "experts.gate_bias": ("mlp.experts.gate_up_proj_bias", False, 0),
    "experts.up_bias": ("mlp.experts.gate_up_proj_bias", False, 1),
    "experts.down_bias": ("mlp.experts.down_proj_bias", False, None),
}
# each fused HF tensor -> (our gate name, our up name)
_INTERLEAVED = {"mlp.experts.gate_up_proj": ("experts.gate_proj", "experts.up_proj"),
                "mlp.experts.gate_up_proj_bias": ("experts.gate_bias", "experts.up_bias")}

# qwen3_vl_moe's fused experts (``expert_layout: fused_chunked``, reference
# ``:336-357``, ``:489-497``): ``mlp.experts.gate_up_proj`` [E, H, 2I] with
# gate in the first half of the last dim and up in the second, and
# ``mlp.experts.down_proj`` [E, I, H], neither transposed. Our name -> (hf
# suffix, the half or None)
_CHUNKED_GATE_UP = "mlp.experts.gate_up_proj"
_CHUNKED: Dict[str, Tuple[str, Optional[int]]] = {
    "experts.gate_proj": (_CHUNKED_GATE_UP, 0),
    "experts.up_proj": (_CHUNKED_GATE_UP, 1),
    "experts.down_proj": ("mlp.experts.down_proj", None),
}

INDEX_NAME = "model.safetensors.index.json"

# --------------------------------------------------------------------------
# The safetensors format
# --------------------------------------------------------------------------
DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I64": torch.int64, "I32": torch.int32,
}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries, ``__metadata__``, byte offset of the data) of a
    .safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + n


class SafetensorsFile:
    """One .safetensors file, read a tensor at a time: the header is parsed
    once, and each :meth:`get_tensor` reads that tensor's bytes alone."""

    def __init__(self, path: str):
        self.path = path
        self.entries, self.metadata, self._data_start = read_header(path)
        for name, e in self.entries.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']}; the port "
                                 f"reads {', '.join(DTYPES)}")

    def keys(self) -> List[str]:
        return list(self.entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.entries[name]["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor on the CPU, in its stored dtype."""
        e = self.entries[name]
        dtype = DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        buf = bytearray(end - begin)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        if not buf:
            return torch.empty(e["shape"], dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(e["shape"])


# (name, dtype, shape, producer of the CPU tensor) for a streamed write
TensorSource = Tuple[str, torch.dtype, Tuple[int, ...], Callable[[], torch.Tensor]]
# (owning module, parameter name) -> the tensor an export writes for it
ReadFn = Callable[[torch.nn.Module, str], torch.Tensor]


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def write_file(path: str, sources: List[TensorSource],
               metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a .safetensors file from ``sources`` in their order, calling
    each producer only when its bytes are written (so a caller streaming off
    the device holds one tensor at a time). Written to a temporary name and
    renamed: a reader never sees a partial file."""
    header: Dict[str, dict] = {}
    off = 0
    for name, dtype, shape, _ in sources:
        if dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {dtype} is not one of {', '.join(DTYPES)}")
        n = _nbytes(dtype, shape)
        header[name] = {"dtype": _DTYPE_NAMES[dtype], "shape": [int(d) for d in shape],
                        "data_offsets": [off, off + n]}
        off += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, dtype, shape, produce in sources:
            t = produce().detach().to("cpu", dtype).contiguous()
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: produced shape {tuple(t.shape)}, declared {tuple(shape)}")
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """``safetensors.torch.save_file``'s counterpart: every tensor, by name."""
    write_file(path, [(k, t.dtype, tuple(t.shape), (lambda t=t: t))
                      for k, t in sorted(tensors.items())], metadata or {"format": "pt"})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, on the CPU."""
    f = SafetensorsFile(path)
    return {k: f.get_tensor(k) for k in f.keys()}


# --------------------------------------------------------------------------
# Lazy reader over a checkpoint directory
# --------------------------------------------------------------------------
class LazyHFTensors:
    """Per-tensor view over a (sharded) safetensors checkpoint directory, or
    over an in-memory mapping (``tensors``): nothing is read until
    :meth:`read`. The shards come from ``model.safetensors.index.json`` when
    the directory has one, else every ``*.safetensors`` file in it."""

    def __init__(self, model_dir: Optional[str], tensors: Optional[Dict[str, torch.Tensor]] = None):
        self._mem = tensors
        self._files: Dict[str, SafetensorsFile] = {}
        self._where: Dict[str, str] = {}
        self._consumed: set = set()
        if tensors is not None:
            return
        index = os.path.join(model_dir, INDEX_NAME)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
            weight_map = None
        if not files:
            raise FileNotFoundError(f"no .safetensors under {model_dir}")
        for fname in files:
            handle = SafetensorsFile(os.path.join(model_dir, fname))
            self._files[fname] = handle
            for key in handle.keys():
                self._where[key] = fname
        if weight_map is not None:
            missing = sorted(k for k, fname in weight_map.items() if self._where.get(k) != fname)
            if missing:
                raise ValueError(f"{index} names tensors its shards do not hold: {missing[:8]}")

    def keys(self) -> List[str]:
        names = self._mem if self._mem is not None else self._where
        return [k for k in names if k not in self._consumed]

    def __contains__(self, name: str) -> bool:
        if name in self._consumed:
            return False
        return name in (self._mem if self._mem is not None else self._where)

    def mark_consumed(self, name: str) -> None:
        self._consumed.add(name)

    def read(self, name: str) -> torch.Tensor:
        """The full tensor on the CPU (marks it consumed)."""
        if name not in self:
            raise KeyError(f"missing tensor {name!r}")
        self.mark_consumed(name)
        if self._mem is not None:
            return torch.as_tensor(self._mem[name])
        return self._files[self._where[name]].get_tensor(name)

    def shape(self, name: str) -> Tuple[int, ...]:
        if self._mem is not None:
            return tuple(self._mem[name].shape)
        return self._files[self._where[name]].shape(name)


# --------------------------------------------------------------------------
# HF checkpoint <-> the port's model
# --------------------------------------------------------------------------
@torch.no_grad()
def hf_to_params(model_dir: Optional[str], cfg: TransformerConfig, model: torch.nn.Module,
                 tensors: Optional[Dict[str, torch.Tensor]] = None,
                 key_map: Optional[Callable[[str], Optional[str]]] = None,
                 experts: Optional[range] = None) -> torch.nn.Module:
    """Fill ``model``'s parameters (``models/transformer.py::Transformer``)
    from an HF checkpoint directory, or from ``tensors`` ({hf name: tensor}),
    one tensor at a time, converted to each parameter's dtype on its device.
    A missing tensor raises ``KeyError``; an untied ``lm_head`` missing from
    the checkpoint is the embedding transposed (the reference's fallback);
    tensors left over are logged, as the reference does. ``key_map`` (the
    reference's, ``:162``) renames each checkpoint key to its text-model
    name, or to None for a key this model does not read (a VLM's tower).
    ``experts``: under expert parallelism the experts this rank holds; the
    per-expert tensors of the others are not read (their rows stay as they
    are, for the plan to cut away), as the reference's EP-sliced reads
    (``module_utils.py:530,867``)."""
    lazy = LazyHFTensors(None if tensors is not None else model_dir, tensors)
    mapped = {k: key_map(k) if key_map else k for k in lazy.keys()}
    alias = {re.sub(r"^model\.", "", m): k for k, m in mapped.items() if m is not None}

    def fetch(name: str, transpose: bool) -> torch.Tensor:
        if name not in alias or alias[name] not in lazy:
            raise KeyError(f"HF checkpoint {model_dir or '(in memory)'} has no tensor "
                           f"{name!r} (nor model.{name})")
        x = lazy.read(alias[name])
        return x.t() if transpose else x

    def put(param: torch.Tensor, x: torch.Tensor, what: str) -> None:
        if tuple(x.shape) != tuple(param.shape):
            raise ValueError(f"{what}: checkpoint shape {tuple(x.shape)} (after the layout "
                             f"conversion), model {tuple(param.shape)}")
        # onto the parameter's device as stored, then cast and transpose there
        param.copy_(x.to(param.device))

    put(model.embed_tokens, fetch("embed_tokens.weight", False), "embed_tokens")
    put(model.norm, fetch("norm.weight", False), "norm")
    for i, layer in enumerate(model.layers):
        # gpt_oss's fused experts (the reference's test, ``:366-370``)
        fused = f"layers.{i}.mlp.router.weight" in alias
        # qwen3_vl_moe's: gate | up halves, the router the generic mlp.gate
        chunked = not fused and f"layers.{i}.{_CHUNKED_GATE_UP}" in alias
        halves: Dict[str, torch.Tensor] = {}  # a fused tensor, read once for both halves
        for pname, param in layer.named_parameters():
            if chunked and pname in _CHUNKED:
                name = f"layers.{i}.{_CHUNKED[pname][0]}"
                if name not in halves:
                    halves[name] = fetch(name, False)
                x = halves[name]
                half = _CHUNKED[pname][1]
                if half is not None:
                    width = x.shape[-1] // 2
                    x = x[..., half * width:(half + 1) * width]
                for e in (experts if experts is not None else range(cfg.num_experts)):
                    put(param[e], x[e], f"layers.{i}.{pname}[{e}]")
            elif fused and pname in _FUSED_MAP:
                suffix, transpose, parity = _FUSED_MAP[pname]
                name = f"layers.{i}.{suffix}"
                if parity is None:
                    x = fetch(name, transpose)
                else:
                    if name not in halves:
                        halves[name] = fetch(name, False)
                    x = halves[name][..., parity::2]
                put(param, x, f"layers.{i}.{pname}")
            elif pname in _EXPERT_MAP:
                tmpl = _EXPERT_MAP[pname]
                for e in range(cfg.num_experts):
                    name = f"layers.{i}.{tmpl.format(e=e)}"
                    if experts is not None and e not in experts:
                        if name in alias:
                            lazy.mark_consumed(alias[name])
                        continue
                    put(param[e], fetch(name, True), f"layers.{i}.{pname}[{e}]")
            elif pname in _LAYER_MAP:
                suffix, transpose = _LAYER_MAP[pname]
                put(param, fetch(f"layers.{i}.{suffix}", transpose), f"layers.{i}.{pname}")
            else:
                raise KeyError(f"layers.{i}.{pname}: no HF name for this parameter")
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" in alias:
            put(model.lm_head, fetch("lm_head.weight", True), "lm_head")
        else:  # untied head missing in the checkpoint: the embedding transposed
            put(model.lm_head, model.embed_tokens.t(), "lm_head")
    remaining = sorted(k for k in lazy.keys() if mapped[k] is not None)
    if remaining:
        logger.warning_rank0("unconsumed HF tensors: %s", remaining[:8])
    return model


def hf_sources(model: torch.nn.Module, cfg: TransformerConfig,
               read: Optional[ReadFn] = None) -> List[TensorSource]:
    """Every HF tensor of ``model``, sorted by name, as (name, dtype, shape,
    producer of the CPU tensor in the parameter's dtype). ``read(owner,
    name)`` gives the tensor a producer copies from (default: the
    parameter itself)."""
    out: List[TensorSource] = []

    def add(name: str, owner: torch.nn.Module, pname: str, transpose: bool, index=None):
        param = owner.get_parameter(pname)
        shape = tuple(param.shape[1:] if index is not None else param.shape)
        if transpose:
            shape = tuple(reversed(shape))

        def produce():
            x = (read(owner, pname) if read else param).detach()
            x = x if index is None else x[index]
            # laid out on the parameter's device, then copied off it
            return (x.t() if transpose else x).contiguous().to("cpu")

        out.append((name, param.dtype, shape, produce))

    def add_interleaved(name: str, owner: torch.nn.Module, pair: Tuple[str, str]):
        gate = owner.get_parameter(pair[0])
        shape = tuple(gate.shape[:-1]) + (2 * gate.shape[-1],)

        def produce():
            g, u = ((read(owner, n) if read else owner.get_parameter(n)).detach()
                    for n in pair)
            # gate in the even columns, up in the odd ones
            return torch.stack([g, u], dim=-1).reshape(shape).to("cpu")

        out.append((name, gate.dtype, shape, produce))

    def add_chunked(name: str, owner: torch.nn.Module):
        gate = owner.get_parameter("experts.gate_proj")
        shape = tuple(gate.shape[:-1]) + (2 * gate.shape[-1],)

        def produce():
            g, u = ((read(owner, n) if read else owner.get_parameter(n)).detach()
                    for n in ("experts.gate_proj", "experts.up_proj"))
            return torch.cat([g, u], dim=-1).to("cpu")

        out.append((name, gate.dtype, shape, produce))

    add("model.embed_tokens.weight", model, "embed_tokens", False)
    add("model.norm.weight", model, "norm", False)
    if not cfg.tie_word_embeddings:
        add("lm_head.weight", model, "lm_head", True)
    fused = cfg.model_type == "gpt_oss"  # the reference's choice, ``:485-492``
    chunked = cfg.expert_layout == "fused_chunked"
    for i, layer in enumerate(model.layers):
        names = dict(layer.named_parameters())
        if fused and "router" in names:
            for suffix, pair in _INTERLEAVED.items():
                if pair[0] in names:
                    add_interleaved(f"model.layers.{i}.{suffix}", layer, pair)
        if chunked and "experts.gate_proj" in names:
            add_chunked(f"model.layers.{i}.{_CHUNKED_GATE_UP}", layer)
        for pname in names:
            if chunked and pname in _CHUNKED:
                if _CHUNKED[pname][1] is None:
                    add(f"model.layers.{i}.{_CHUNKED[pname][0]}", layer, pname, False)
            elif fused and pname in _FUSED_MAP:
                suffix, transpose, parity = _FUSED_MAP[pname]
                if parity is None:
                    add(f"model.layers.{i}.{suffix}", layer, pname, transpose)
            elif pname in _EXPERT_MAP:
                for e in range(cfg.num_experts):
                    add(f"model.layers.{i}.{_EXPERT_MAP[pname].format(e=e)}", layer, pname, True,
                        e)
            else:
                suffix, transpose = _LAYER_MAP[pname]
                add(f"model.layers.{i}.{suffix}", layer, pname, transpose)
    return sorted(out, key=lambda s: s[0])


def params_to_hf(model: torch.nn.Module, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The inverse mapping: {hf name: CPU tensor in the parameter's dtype}
    (the whole model on the host; :func:`save_hf_checkpoint` streams
    instead)."""
    return {name: produce() for name, _, _, produce in hf_sources(model, cfg)}


def _shards(sources: List[TensorSource], max_shard_bytes: int) -> List[List[TensorSource]]:
    """The reference's split: tensors in name order, a new shard when the
    next one would pass ``max_shard_bytes``."""
    shards: List[List[TensorSource]] = [[]]
    size = 0
    for src in sources:
        n = _nbytes(src[1], src[2])
        if size + n > max_shard_bytes and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append(src)
        size += n
    return shards


def shard_names(n: int) -> Iterator[str]:
    """The reference's file names for ``n`` shards."""
    for i in range(n):
        yield "model.safetensors" if n == 1 else f"model-{i + 1:05d}-of-{n:05d}.safetensors"


def save_hf_checkpoint(model: torch.nn.Module, cfg: TransformerConfig, out_dir: str,
                       max_shard_bytes: int = 4 * 1024**3, read: Optional[ReadFn] = None) -> None:
    """HF-format sharded safetensors export with ``config.json`` (and, for
    more than one shard, ``model.safetensors.index.json``), in the
    parameters' dtype, streamed off the device one tensor at a time, in name
    order. ``read(owner, name)``, where given, gives each tensor in place of
    the parameter ``name`` of module ``owner`` (LoRA's merged export)."""
    write_hf_checkpoint(hf_sources(model, cfg, read), cfg.to_hf_config(), out_dir,
                        max_shard_bytes)


def write_hf_checkpoint(sources: List[TensorSource], hf_config: Dict, out_dir: str,
                        max_shard_bytes: int = 4 * 1024**3) -> None:
    """Write ``sources`` (sorted by name) as the reference's shards, with
    ``config.json`` = ``hf_config`` (and the index JSON for more than one
    shard)."""
    os.makedirs(out_dir, exist_ok=True)
    shards = _shards(sources, max_shard_bytes)
    index = {"metadata": {"total_size": sum(_nbytes(s[1], s[2]) for sh in shards for s in sh)},
             "weight_map": {}}
    for fname, shard in zip(shard_names(len(shards)), shards):
        write_file(os.path.join(out_dir, fname), shard, {"format": "pt"})
        for src in shard:
            index["weight_map"][src[0]] = fname
    if len(shards) > 1:
        with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    logger.info_rank0("saved HF checkpoint to %s (%d shards)", out_dir, len(shards))
