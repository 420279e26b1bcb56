"""K5: causal sliding-window flash-attention forward with GQA."""
