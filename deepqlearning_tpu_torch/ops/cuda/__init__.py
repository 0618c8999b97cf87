"""The port's hand-written Hopper kernels (sources in ``csrc/``), each with
its plain PyTorch twin and a launch counter on its CUDA wrapper."""
