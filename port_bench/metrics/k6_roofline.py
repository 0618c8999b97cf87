"""The recurrent collect (K6): its share of its roofline in %
(``harness/readers.py::roofline``; work from
``kernels/fc_rnn_kernel.py``)."""
from port_bench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "fc_rnn_kernel")
