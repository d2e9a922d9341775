"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``).  Cells, configurations,
traffic mixes, metrics and kernel-work counts are each a file of their
own, found by the names in ``BENCHMARK.json``."""
