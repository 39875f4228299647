"""The plain PyTorch and numpy reference that decides a run's `correct`.

It imports nothing of tpuray_torch, nor jax, nor tpuray: the modules here
are frozen copies of the port's plain stages, with a traversal of their
own (trace.py), and build their scene from the benchmark's inputs."""
