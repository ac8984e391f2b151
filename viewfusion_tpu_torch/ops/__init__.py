"""Ops of the port: the CUDA kernel wrappers and their plain versions."""
