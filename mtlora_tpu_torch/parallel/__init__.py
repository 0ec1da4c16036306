"""Several processes, one global batch (counterpart of
``mtlora_tpu/parallel``)."""
