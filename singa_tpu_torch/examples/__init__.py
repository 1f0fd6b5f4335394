"""Trainer scripts of the port (counterparts of examples/); run each as
`python -m singa_tpu_torch.examples.<name>`."""
