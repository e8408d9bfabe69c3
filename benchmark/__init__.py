"""The benchmark of slamtpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line last. Everything belonging to one configuration, traffic mix, driver,
metric or cell's limits sits in a file of its own, found by name:

  configs/<config>.json     the configuration as run (the port's config fields)
  traffic/<mix>.json        the traffic mix: scene, request shape, sample sizes
  drivers/<pipeline>_<mode>.py  the entry a mix drives and its comparison
  metrics/<metric>.py       a reader that takes one metric from a run
  limits/<cell>.json        the limits of the numbers that decide `correct`

inputs/ holds the frozen scene generator and the kernels' byte and
operation counts; reference/ the plain reference. Nothing here imports jax,
jaxlib or the JAX package.
"""
