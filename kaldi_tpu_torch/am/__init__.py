"""Acoustic models."""
