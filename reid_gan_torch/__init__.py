"""PyTorch/CUDA port of ``reid_gan_tpu`` for one NVIDIA H100.

Mirrors the JAX package's module paths. Dense layers go to cuDNN/cuBLAS
through torch; the JAX package's hand-fused device programs on the eval path
are CUDA C++ kernels for ``sm_90a`` (``csrc/``, bound in ``kernels``), each
with a plain PyTorch version beside it in the module that calls it. Entry
points run on the card unless the caller asks for the CPU
(``device.resolve_device``).
"""
