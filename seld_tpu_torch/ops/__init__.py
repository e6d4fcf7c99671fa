"""Quaternion / dual-quaternion algebra ops (torch) and the CUDA kernels."""
