"""Entry-point drivers (``python -m repro_torch.launch.<name>``)."""
