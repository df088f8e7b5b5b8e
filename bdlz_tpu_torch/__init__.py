"""bdlz_tpu_torch — the PyTorch/CUDA port of ``bdlz_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package (``bdlz_tpu``), which stays as the
reference; this package imports nothing of it and nothing of JAX.  Entry
points run on the first CUDA card unless the caller passes
``device="cpu"``.
"""
