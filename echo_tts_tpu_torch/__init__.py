"""Echo-TTS in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `echo_tts_tpu`, which stays the reference. The two
packages share no code: this one imports torch, numpy and the standard
library only (scipy for resampling). Each module mirrors its JAX
counterpart's path and names (`core/`, `ops/`, `models/`, `sampling/`,
`pipeline/`, `bench/`, `checkpoints/`, `train/`, `serve/`, `scripts/`,
`parallel/`, `utils/`). The TPU kernels
of the one-shot and training paths have hand-written CUDA counterparts
under `csrc/`, built with nvcc at first use (`ops/_build.py`); each wrapper
runs its plain PyTorch version only for tensors on the CPU.
"""
