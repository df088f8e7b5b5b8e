"""Physics layers L1-L3 (thermodynamics, percolation, source) in PyTorch."""
