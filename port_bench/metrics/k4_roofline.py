"""The fused collect (K4): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/fc_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "fc_kernel")
