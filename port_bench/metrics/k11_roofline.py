"""The target net's Q(s') (K11): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/dr_target_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "dr_target_kernel")
