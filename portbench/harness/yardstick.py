"""The yardstick: the card's peaks and the work each layer must do.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W limit
(dense rates): float32 outside the tensor cores 67 TFLOP/s, TF32 495,
bf16 989, HBM3 3.35 TB/s.  The program computes in float32 with TF32 off,
so its shares are taken against the float32 rate.  Operations and bytes
are worked out here from the shapes, never read from the program: a
later change to the program cannot move the yardstick.

Operations count ``2 m n k`` per matrix product; convolutions count their
multiply-adds the same way.  Training counts the forward and twice the
forward for the backward; recomputation under a checkpoint is not counted.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_HBM_BYTES_PER_S = 3.35e12

F32 = 4


def cnn_forward_flops(config: dict) -> int:
    """One image through the paper's CNN: two 3x3 'same' convolutions,
    each before a 2x2 pool, then two dense layers (biases and pools are not
    products and are not counted)."""
    h = w = config["image"][0]
    c_in = config["image"][2]
    flops = 0
    for c_out in config["conv_channels"]:
        k = config["kernel"]
        flops += 2 * h * w * c_out * k * k * c_in
        h, w, c_in = h // 2, w // 2, c_out
    d_in = h * w * c_in
    for d_out in (*config["dense"], config["classes"]):
        flops += 2 * d_in * d_out
        d_in = d_out
    return flops


def cnn_train_flops_per_sample(config: dict) -> int:
    return 3 * cnn_forward_flops(config)


def cnn_param_count(config: dict) -> int:
    h = w = config["image"][0]
    c_in = config["image"][2]
    k = config["kernel"]
    n = 0
    for c_out in config["conv_channels"]:
        n += k * k * c_in * c_out + c_out
        h, w, c_in = h // 2, w // 2, c_out
    d_in = h * w * c_in
    for d_out in (*config["dense"], config["classes"]):
        n += d_in * d_out + d_out
        d_in = d_out
    return n


def lm_matmul_params(config: dict) -> int:
    """Weights that take part in a product once per token: each layer's
    q, k, v, o and SwiGLU projections, and the LM head (the tied embedding
    is looked up, not multiplied, on the way in)."""
    d = config["hidden_size"]
    H = config["num_attention_heads"]
    Kv = config["num_key_value_heads"]
    hd = d // H
    ff = config["intermediate_size"]
    per_layer = d * H * hd + 2 * d * Kv * hd + H * hd * d + 3 * d * ff
    return config["num_hidden_layers"] * per_layer + d * config["vocab_size"]


def lm_param_count(config: dict) -> int:
    d = config["hidden_size"]
    H = config["num_attention_heads"]
    Kv = config["num_key_value_heads"]
    hd = d // H
    ff = config["intermediate_size"]
    per_layer = (d * H * hd + 2 * d * Kv * hd + H * hd * d + 3 * d * ff
                 + (H + 2 * Kv) * hd + 2 * d)
    embed = config["vocab_size"] * d
    head = 0 if config["tie_word_embeddings"] else embed
    return config["num_hidden_layers"] * per_layer + embed + head + d


def lm_attention_forward_flops(config: dict, seq: int) -> int:
    """Causal attention of one sequence: each query against the keys at or
    before it, scores and weighted values, every layer and head."""
    H = config["num_attention_heads"]
    hd = config["hidden_size"] // H
    pairs = seq * (seq + 1) // 2
    return config["num_hidden_layers"] * 2 * 2 * H * hd * pairs


def lm_train_flops(config: dict, batch: int, seq: int) -> int:
    """One SGD step on ``batch`` rows of ``seq`` predicted tokens."""
    fwd = (2 * lm_matmul_params(config) * batch * seq
           + batch * lm_attention_forward_flops(config, seq))
    return 3 * fwd


def weighted_agg_bytes(n_params: int, itemsize: int = F32) -> int:
    """K2, one merge: the global and the local model read, the new global
    written."""
    return 3 * n_params * itemsize


def ring_agg_bytes(uploads: int, worlds: int, n_params: int,
                   itemsize: int = F32) -> int:
    """K1, one chain of ``uploads`` merges over ``worlds`` models: each
    upload row read once, the global read and written once."""
    return (uploads + 2) * worlds * n_params * itemsize


def cross_entropy_bytes(rows: int, vocab: int, itemsize: int = F32) -> int:
    """K3, one loss: the logits read once (labels and the per-row outputs
    are rounding next to them)."""
    return rows * vocab * itemsize
