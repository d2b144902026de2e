"""Merge algebra, its CUDA kernels and their builder."""
