"""PyTorch + CUDA port of ``snn_for_object_detection_tpu`` for NVIDIA
Hopper. Imports torch and numpy only; the JAX package is its reference
in the tests and nowhere else."""
