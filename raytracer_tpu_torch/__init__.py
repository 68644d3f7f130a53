"""PyTorch + CUDA port of ``raytracer_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and semantics.  Plain tensor code is PyTorch; the
kernels are CUDA C++ for ``sm_90a`` (``csrc/*.cu``), built with ``nvcc`` at
first use (``core/native.py``).

Entry points place their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of running on the CPU.
"""
