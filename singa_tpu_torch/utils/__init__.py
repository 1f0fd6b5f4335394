"""Host utilities of the port (counterpart of singa_tpu/utils/)."""
