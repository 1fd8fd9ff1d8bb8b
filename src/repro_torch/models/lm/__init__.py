"""LM tier of the port: dense attention-only transformers for serving
(counterpart of ``repro.models.lm``)."""
