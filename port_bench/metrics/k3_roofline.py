"""The grouped update (K3): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/fu_group_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "fu_group_kernel")
