"""The benchmark of sleipnir_tpu_torch on one NVIDIA H100: `run.py` is
its command; `BENCHMARK.json` at the repository's root names its cells."""
