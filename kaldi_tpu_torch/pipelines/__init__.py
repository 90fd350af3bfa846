"""Task builders, scoring and end-to-end decode pipelines."""
