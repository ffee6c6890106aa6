"""Kernels of the port (``csrc/``), their builds, wrappers and plain versions."""
