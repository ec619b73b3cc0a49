"""utils layer of sentinel_tpu_torch (see the package docstring)."""
