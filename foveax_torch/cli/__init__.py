"""Command-line interface: ``python -m foveax_torch.cli.main``."""
