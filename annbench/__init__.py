"""The benchmark of the PyTorch/CUDA port (`diskann_tpu_torch`): one run of
one cell is `python3 annbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`; `annbench/README.md` says how cells are added."""
