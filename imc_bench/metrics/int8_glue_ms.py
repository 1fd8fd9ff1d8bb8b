"""``int8_glue_ms``: device milliseconds a request of every traced
operation that is not one of the port's INT8 kernels (quantization,
requantized activations, residual adds, pooling, copies)."""

from imc_bench import trace

INT8_KERNELS = ("imc_conv2d", "imc_mvm")


def read(run):
    t = run.traced
    if t is None or not any(k in o.name for o in t.ops for k in INT8_KERNELS):
        return None
    glue = trace.device_seconds(t, lambda o: not any(k in o.name for k in INT8_KERNELS))
    return 1e3 * glue / t.requests
