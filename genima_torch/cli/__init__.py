"""Command-line entry points of the port (``python -m genima_torch.cli.<name>``)."""
