"""teochat-torch: the PyTorch / CUDA (Hopper) port of teochat_tpu.

Modules mirror teochat_tpu/; the JAX package stays the reference and is
never imported from here: host-only modules (config, constants,
conversation, mm_utils, utils, data.sampler, data.processing,
eval.inference) are this package's own copies under the same names.
Importing this package builds nothing: the CUDA kernels in csrc/ are
compiled at first use (ops/_build.py).
"""
