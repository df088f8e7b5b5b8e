"""Table and kernel ops: the KJMA F(y) table and the hand-written CUDA kernels."""
