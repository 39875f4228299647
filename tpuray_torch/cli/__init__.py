"""cli layer of tpuray_torch: `python -m tpuray_torch.cli.main`."""
