"""Solver kernels and containers (torch)."""
