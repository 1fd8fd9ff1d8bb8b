"""Optimizers of the port (counterpart of ``repro.optim``): AdamW with its
schedule, and error-feedback INT8 gradient compression."""
