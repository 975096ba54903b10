"""Losses, metrics and preprocessing of the port."""
