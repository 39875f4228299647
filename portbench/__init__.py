"""The benchmark of tpuray_torch on one NVIDIA H100: `python3 -m portbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` (see run.py)."""
