"""Host-side utilities of the port (profiling counters, output files)."""
