"""Model zoo (counterpart of singa_tpu/models/): the GPT decoder so far."""
