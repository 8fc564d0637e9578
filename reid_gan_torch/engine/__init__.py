"""Evaluation engine of the port (feature extraction, rank metrics)."""
