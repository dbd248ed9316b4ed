"""Models (port of ``repro.models``): the transformer LM (dense and MoE;
prefill, decode, ``lm_loss``), xDeepFM and the four GNNs, for serving and
training."""
