"""Measurement helpers and scripts for the port on a CUDA card."""
