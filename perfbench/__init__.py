"""The benchmark of ``repro_torch`` on one H100: see ``run.py``."""
