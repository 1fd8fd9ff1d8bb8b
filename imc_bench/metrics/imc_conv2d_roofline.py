"""``imc_conv2d_roofline``: the least time of a request's convs (each
launch's bytes at the configuration's HBM rate or its operations at its
int8 peak, whichever is longer, from the frozen ``work.conv_work``) over
the traced device time of the ``imc_conv2d`` kernels a request."""

from imc_bench import trace, work

KERNEL = "imc_conv2d"


def read(run):
    t = run.traced
    if t is None:
        return None
    spent = trace.device_seconds(t, lambda o: KERNEL in o.name)
    if spent <= 0:
        return None
    cfg = run.cell.config
    shapes = run.cell.reference.conv_shapes(cfg, run.cell.traffic["frames_per_request"])
    least = sum(work.bound_s(*work.conv_work(s), cfg["peak_ops_per_s"],
                             cfg["hbm_bytes_per_s"]) for s in shapes)
    return 100.0 * least * t.requests / spent
