"""The benchmark of raytracer_tpu_torch on one NVIDIA H100 (``run.py``)."""
