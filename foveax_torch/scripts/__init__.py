"""The port's counterparts of the JAX package's tools (``scripts/``), each
run as a module from the repository root:

    python -m foveax_torch.scripts.stage_bench      per-stage timings
    python -m foveax_torch.scripts.fuzz_fused       differential shape fuzz
    python -m foveax_torch.scripts.two_process_demo server and client in two
                                                    processes
    python -m foveax_torch.scripts.soak             session churn, no residue

Each takes ``--device`` (``cuda`` unless ``--device cpu`` is given, where
every kernel is replaced by its plain version).
"""
