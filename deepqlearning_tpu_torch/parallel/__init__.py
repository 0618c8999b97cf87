"""Data parallelism on ``torch.distributed`` (``deepqlearning_tpu.parallel``)."""
