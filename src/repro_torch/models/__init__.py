"""Serving models (port of ``repro.models``, dense archs): the
transformer LM (prefill, decode) and xDeepFM."""
