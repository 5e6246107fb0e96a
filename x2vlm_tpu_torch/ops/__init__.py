"""Attention kernels and shared layers of the port. Importing builds
nothing: each kernel compiles at its first launch on a CUDA tensor."""
