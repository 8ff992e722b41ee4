"""swbench: the benchmark of the PyTorch + CUDA port (`sitewhere_tpu_torch`).

`python3 -m swbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card(s) of the
machine it starts on. See README.md.
"""
