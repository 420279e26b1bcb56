"""The four assigned input shapes.

``train_*`` shapes lower ``train_step`` (fwd + bwd + SGD); ``decode_*`` shapes
lower ``serve_step`` (ONE new token against a ``seq_len`` KV cache);
``prefill_*`` lowers the forward+cache-build pass.
"""
from __future__ import annotations

from dataclasses import dataclass

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, TRAIN),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, PREFILL),
    "decode_32k": InputShape("decode_32k", 32_768, 128, DECODE),
    "long_500k": InputShape("long_500k", 524_288, 1, DECODE),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def legal_shapes(cfg) -> list[str]:
    """Shapes legal for an arch (long_500k requires sub-quadratic attention)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
