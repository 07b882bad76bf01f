"""The benchmark of rajepy_tpu_torch (see README.md)."""
