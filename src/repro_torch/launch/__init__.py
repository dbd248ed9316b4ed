"""Launchers (port of ``repro.launch``): ``launch.train``. The mesh
helpers (``launch/mesh.py``) wait with ``dryrun`` (ROADMAP queue 1)."""
