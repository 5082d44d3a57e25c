"""teochat-torch: the PyTorch / CUDA (Hopper) port of teochat_tpu.

Modules mirror teochat_tpu/; the JAX package stays the reference. Host-only
modules (config, constants, conversation, mm_utils, eval.inference) are
imported from teochat_tpu. Importing this package builds nothing: the CUDA
kernels in csrc/ are compiled at first use (ops/_build.py).
"""
