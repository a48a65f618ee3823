"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a
run, ``python3 pcabench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; see ``harness``."""
