"""Multi-device proving (port of otti_tpu/parallel/)."""
