"""The benchmark of the PyTorch and CUDA port (``deepqlearning_tpu_torch``):
its harness (``harness/``), the plain reference it checks against
(``reference/``), and the configurations, cells, per-layer metrics and
kernel work counts it finds by name."""
