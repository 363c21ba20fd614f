"""Tensor operations of the port (NCHW unless a docstring says otherwise)."""
