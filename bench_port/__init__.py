"""The benchmark of the PyTorch and CUDA port, ``sventt_tpu_torch``.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
its result as the last line of standard output.
"""
