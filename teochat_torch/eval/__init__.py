"""Evaluation harness of the port (teochat_tpu/eval)."""
