"""The benchmark of ``learn_nerf_tpu_torch`` on an NVIDIA H100 (see
``BENCHMARK.json`` and ``PERF.md``)."""
