"""Model tier of the port: INT8 quantization and the CNN workloads."""
