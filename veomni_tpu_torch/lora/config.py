"""LoRA configuration: a copy of ``veomni_tpu/lora/config.py`` (rank,
alpha, the target and override regexes over the reference's leaf paths)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# default targets: attention + mlp projections incl. fused MoE expert tensors
DEFAULT_TARGETS = [
    r"layers\.(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)$",
    r"layers\.experts\.(gate_proj|up_proj|down_proj)$",
]


@dataclass
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    target_patterns: List[str] = field(default_factory=lambda: list(DEFAULT_TARGETS))
    # per-pattern rank/alpha overrides: {pattern: {"rank": r, "alpha": a}}
    overrides: Dict[str, Dict[str, float]] = field(default_factory=dict)
    train_bias: bool = False  # biases/norms stay frozen by default

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["LoraConfig"]:
        if not d:
            return None
        return cls(**d)
