"""The recurrent grouped update (K5): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/dr_group_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "dr_group_kernel")
