"""The benchmark of dmnerf_torch on one NVIDIA H100 (run.py runs one cell)."""
