"""ultragroth_tpu_torch — the PyTorch + CUDA port of ultragroth_tpu.

BN254 Groth16 proving with the hot path (MSM bucket loop, curve folds,
NTT butterflies, Fr products) in CUDA kernels written by hand for Hopper
(`csrc/`), bound through a plain C interface and `ctypes`
(`ops/_build.py`, `ops/kernels.py`).  Every kernel has a plain PyTorch
version of the same function beside it; a wrapper runs that version only
for tensors on the CPU.

The package imports `torch` and numpy, never `jax` and nothing of
`ultragroth_tpu`: the host-side modules it shares with the JAX package
(`constants`, `io`, `oracle`, `protocol/groth16.py`, `testkit`) are its
own copies.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
