"""Bit-packed row operations on torch tensors."""
