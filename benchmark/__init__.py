"""The benchmark of the PyTorch/CUDA port: `python3 -m benchmark.run
--workload <name> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
