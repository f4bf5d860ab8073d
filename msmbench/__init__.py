"""The benchmark of `tpu_msm_torch` on the NVIDIA H100 (`BENCHMARK.json` at
the repository's root). `python -m msmbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once; see `run.py`. Nothing here
imports JAX or the JAX package `tpu_msm`."""
