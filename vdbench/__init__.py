"""The benchmark of visdial_tpu_torch, the PyTorch and CUDA port.

One run measures one cell of BENCHMARK.json (a model configuration under a
traffic mix) and prints one JSON line:

    python3 -m vdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in BENCHMARK.json (spec.py): configs/<name>.json,
traffic/<mix>.json (read by the one generator, traffic.py; its "kind" names
the driver, drivers/<kind>.py), limits/<cell>.json (what decides
`correct`) and metrics/<metric>.py (one reader a metric).  The plain
reference that decides `correct` is reference/; it imports nothing of the
port.  The harness imports the port's entry points that a cell drives and
nothing else of it, and never JAX or the JAX package.
"""
