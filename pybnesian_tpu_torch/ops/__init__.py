"""Torch numeric core of the port: plain tensor functions and the wrappers
of the hand-written CUDA kernels (sources in ``pybnesian_tpu_torch/csrc``).
Host layers (factors, scores, search) call into here; nothing in here
touches host-side model objects."""
