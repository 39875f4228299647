"""train layer of tpuray_torch (see the package docstring)."""
