"""PyTorch/CUDA port of the speech_editing_tpu region-edit path.

The package mirrors the JAX package's module names and runs on an NVIDIA
GPU: every Pallas TPU kernel on the edit path has a hand-written CUDA
counterpart under ``csrc/`` (built with ``nvcc`` at first use, bound through
``ctypes``), and each kernel wrapper keeps a plain PyTorch version that runs
when its inputs lie on the CPU. Entry points default to ``device="cuda"``.
"""
