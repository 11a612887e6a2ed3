"""The PyTorch port's benchmark (ravqa_tpu_torch on one NVIDIA H100).

`python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once; see portbench/run.py. The
plain reference is portbench/reference/, which imports nothing of the
program.
"""
