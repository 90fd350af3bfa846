"""Decoders."""
