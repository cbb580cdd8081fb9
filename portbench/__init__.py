"""The benchmark of ans_tpu_torch, the PyTorch and CUDA port, on one H100.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell (portbench/run.py).  The cells, metrics and
bounds are in BENCHMARK.json at the root; each configuration, traffic mix,
metric and codec is a file of its own here (portbench/manifest.py).  The
plain reference that decides `correct` is the reference side of the
configuration's codec: portbench/reference.py for the codec `lane`,
references/<codec>.py for another; it imports nothing of the program.
"""
