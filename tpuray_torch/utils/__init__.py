"""utils layer of tpuray_torch: frame metrics and FrameState checkpoints."""
