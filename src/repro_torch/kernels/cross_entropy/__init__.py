"""K3: per-row cross-entropy (Eq. 1): CUDA kernel (``ops``), plain version
(``ref``)."""
