"""Models (port of ``repro.models``, dense archs): the transformer LM
(prefill, decode, ``lm_loss``) and xDeepFM, for serving and training."""
