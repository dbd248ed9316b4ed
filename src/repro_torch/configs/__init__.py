"""Architecture configs and shape sets (port of ``repro.configs``, the
serving archs)."""
