"""Benchmark tooling: synthetic data and the job registry (`harness`,
`registry`), recall and latency statistics (`recall`, `stats`), device op
microbenchmarks (`kernels`), the interleaved A/B gate (`abgate`), the
streaming runbook (`runbook`) and the CLI (``python -m
diskann_tpu_torch.bench``)."""
