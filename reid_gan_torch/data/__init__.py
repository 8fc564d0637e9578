"""Data pipeline: dataset scanners, host loader, synthetic factory."""
