"""Fused MAFL aggregation: CUDA kernel (``ops``), plain version (``ref``)."""
