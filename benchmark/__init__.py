"""The H100 benchmark of foveax_torch's served path (``BENCHMARK.json``)."""
