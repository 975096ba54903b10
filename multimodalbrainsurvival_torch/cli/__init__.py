"""Command-line entry points of the port (``python -m
multimodalbrainsurvival_torch.cli.<name>``)."""
