"""The stratified PER draw (K2): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/tree_sample_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "tree_sample_kernel")
