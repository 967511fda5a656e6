"""The benchmark of the PyTorch and CUDA port: one command runs one cell
once (``python3 perfbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>``). Configurations, cells, drivers, metric readers and
kernel counts are files of their own, found by name."""
