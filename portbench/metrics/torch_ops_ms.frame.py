"""Device milliseconds a frame of every device operation that is not one
of the program's hand-written kernels nor NCCL's: the shading, G-buffer
and denoiser glue's PyTorch operations."""


def read(ctx):
    if ctx.unit != "frame" or not ctx.trace.device_ops:
        return None
    return ctx.trace.us_not_hand_written() / 1e3 / ctx.units
