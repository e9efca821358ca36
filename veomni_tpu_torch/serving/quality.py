"""Fixed-seed quality gate for the serving features that are not bit-exact.

Port of ``veomni_tpu/serving/quality.py`` (``fixed_corpus``,
``teacher_forced_logits``, ``_ppl``, ``_topk_overlap``, ``quality_stats``,
``:44-135``) and of the repo-wide bounds and ``assert_quality_gate`` of
``tests/tools/quality_gate.py`` (``:27-60``), copied here so the port needs
nothing of the test tree.

The int8 KV blocks and int8 decode weights change values, so token parity
with the dense engine cannot certify them; this gate bounds two deltas of a
teacher-forced scoring of a fixed corpus against the unquantized path: the
relative change of the perplexity (``exp`` of the mean NLL of each next
token under the previous position's logits) and the mean top-k overlap of
the logits (the neighbourhood greedy and top-k serving sample from).

Scoring runs the real paged serving path: one ``paged_verify_step`` a
sequence (S = 1, all T tokens one verify batch) against fresh pools in the
requested storage, so the quantize-on-write and dequantize-in-attend code
under test is the code the engine runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from veomni_tpu_torch.models import decode as decode_mod
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.ops.quantization import make_kv_pool

#: max relative teacher-forced perplexity change against the dense path
PPL_REL_DELTA_BOUND = 0.02
#: min mean top-k overlap against the dense path (k = TOP_K)
TOPK_OVERLAP_BOUND = 0.90
#: the neighbourhood the overlap bound is pinned against
TOP_K = 8


def fixed_corpus(vocab_size: int, *, n_seqs: int = 4, length: int = 24,
                 seed: int = 0) -> List[List[int]]:
    """The gate's fixed-seed token corpus (numpy's default_rng), tokens in
    [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab_size, size=length)]
            for _ in range(n_seqs)]


def teacher_forced_logits(params, cfg: TransformerConfig, tokens: Sequence[int], *,
                          kv_quant: str = "none", block_size: int = 16,
                          on_device: bool = False):
    """Per-position next-token logits [T, V] f32 of one sequence, scored
    through the paged serving path in the requested KV storage. ``params``
    is the engine's parameter set (``models/decode.py::_compute_cast``,
    int8 projections included); row j is computed with rows 0..j written to
    the (possibly quantized) pool and attended through the block table.
    A numpy array, or with ``on_device`` the tensor where it was computed."""
    dev = params["embed_tokens"].device
    t = len(tokens)
    nb = -(-t // block_size)
    shape = (cfg.num_hidden_layers, nb + 1, block_size, cfg.num_key_value_heads, cfg.head_dim)
    pools = (make_kv_pool(shape, kv_quant, cfg.dtype, dev),
             make_kv_pool(shape, kv_quant, cfg.dtype, dev))
    # block 0 is the null block; the sequence owns blocks 1..nb
    table = torch.arange(1, nb + 1, device=dev)[None]
    logits = decode_mod.paged_verify_step(
        params, cfg, pools, table, torch.zeros(1, dtype=torch.long, device=dev),
        torch.tensor(tokens, device=dev)[None], torch.full((1,), t, device=dev))
    return logits[0].float() if on_device else logits[0].float().cpu().numpy()


def _ppl(logits: np.ndarray, tokens: Sequence[int]) -> float:
    """Teacher-forced perplexity: exp(mean NLL of tokens[j+1] under
    logits[j])."""
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    nxt = torch.tensor(tokens[1:])
    nll = -lp[:-1].gather(-1, nxt[:, None])[:, 0]
    return float(torch.exp(nll.mean()))


def _topk_overlap(ref: np.ndarray, quant: np.ndarray, k: int) -> float:
    """Mean |topk(ref) & topk(quant)| / k over positions."""
    ri = np.argsort(-ref, axis=-1)[:, :k]
    qi = np.argsort(-quant, axis=-1)[:, :k]
    inter = [len(set(r.tolist()) & set(q.tolist())) for r, q in zip(ri, qi)]
    return float(np.mean(inter) / k)


def quality_stats(model, cfg: TransformerConfig, corpus: Sequence[Sequence[int]], *,
                  kv_quant: str = "none", weight_quant: str = "none", top_k: int = 8,
                  block_size: int = 16, device=None) -> Dict[str, float]:
    """Score ``corpus`` through the dense path and the quantized one ->
    ``{ppl_ref, ppl_quant, ppl_rel_delta, topk_overlap}``, ``ppl_rel_delta =
    |ppl_quant - ppl_ref| / ppl_ref`` over the whole corpus, the overlap a
    mean over positions. ``model`` is a ``Transformer`` or its state; both
    parameter sets are cast on ``device`` (default: the model's)."""
    params = decode_mod._compute_cast(model, cfg, device=device)
    qparams = (decode_mod._compute_cast(model, cfg, weight_quant="int8", device=device)
               if weight_quant == "int8" else params)
    nll_ref: List[float] = []
    nll_q: List[float] = []
    overlaps: List[float] = []
    for tokens in corpus:
        ref = teacher_forced_logits(params, cfg, tokens, kv_quant="none", block_size=block_size)
        qnt = teacher_forced_logits(qparams, cfg, tokens, kv_quant=kv_quant,
                                    block_size=block_size)
        nll_ref.append(np.log(_ppl(ref, tokens)))
        nll_q.append(np.log(_ppl(qnt, tokens)))
        overlaps.append(_topk_overlap(ref, qnt, top_k))
    ppl_ref = float(np.exp(np.mean(nll_ref)))
    ppl_quant = float(np.exp(np.mean(nll_q)))
    return {"ppl_ref": ppl_ref, "ppl_quant": ppl_quant,
            "ppl_rel_delta": abs(ppl_quant - ppl_ref) / ppl_ref,
            "topk_overlap": float(np.mean(overlaps))}


def gate_failures(stats: Dict[str, float]) -> List[str]:
    """The pinned bounds ``stats`` breaks, each as a message (none: it
    passes)."""
    bad = []
    if not stats["ppl_rel_delta"] <= PPL_REL_DELTA_BOUND:
        bad.append(f"ppl_rel_delta {stats['ppl_rel_delta']:.5f} exceeds {PPL_REL_DELTA_BOUND} "
                   f"(ppl {stats['ppl_ref']:.4f} -> {stats['ppl_quant']:.4f})")
    if not stats["topk_overlap"] >= TOPK_OVERLAP_BOUND:
        bad.append(f"top-{TOP_K} overlap {stats['topk_overlap']:.4f} below "
                   f"{TOPK_OVERLAP_BOUND}")
    return bad


def assert_quality_gate(model, cfg: TransformerConfig, *, kv_quant: str = "none",
                        weight_quant: str = "none", block_size: int = 16,
                        corpus: Optional[Sequence[Sequence[int]]] = None,
                        device=None) -> Dict[str, float]:
    """Score the quantized path against the dense one on the fixed-seed
    corpus (``corpus=None``: :func:`fixed_corpus` of the vocab) and raise
    ``AssertionError`` past the pinned bounds; returns the stats."""
    if corpus is None:
        corpus = fixed_corpus(cfg.vocab_size)
    stats = quality_stats(model, cfg, corpus, kv_quant=kv_quant, weight_quant=weight_quant,
                          top_k=TOP_K, block_size=block_size, device=device)
    bad = gate_failures(stats)
    if bad:
        raise AssertionError(f"quality gate (kv_quant={kv_quant}, weight_quant={weight_quant}): "
                             + "; ".join(bad))
    return stats
