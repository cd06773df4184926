"""The benchmark of gala_tpu_torch (see README.md)."""
