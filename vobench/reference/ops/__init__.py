"""Tensor operations of the reference tracking path."""
