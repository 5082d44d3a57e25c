"""The port's measurement entry points (run each as `python3 -m teochat_torch.bench.<name>`).

- `int4_kernel`: the int4 unpack variants of scripts/bench_int4_kernel.py;
- `vit_attention`: the ViT attention variants of scripts/bench_vit_attention.py;
- `main`: the phases of bench.py whose modules the port has.

`_timing` holds the one timing helper they, `chip_smoke.py` and
`chip_probe.py` share.
"""
