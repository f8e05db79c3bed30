"""PyTorch/CUDA port of allocnet_tpu for one NVIDIA H100.

Mirrors the JAX package's module layout (config, ops, models, planner,
utils, train, parallel, viz; `cli` is the counterpart of
scripts/allocnet.py).  It imports neither JAX nor anything of `allocnet_tpu`; the
tests hold each module against its JAX counterpart on the CPU.
"""
