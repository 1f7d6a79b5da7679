"""genmmrec_tpu_torch: the PyTorch/CUDA port of genmmrec_tpu for NVIDIA Hopper.

The JAX package ``genmmrec_tpu`` beside it is the reference. This package
imports neither it nor JAX. Its CUDA kernels live in ``csrc/`` and are built
by ``ops/_build.py`` at first use.
"""
