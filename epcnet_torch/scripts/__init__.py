"""Measurement scripts of the port, run as ``python -m epcnet_torch.scripts.<name>``.
Nothing runs at import."""
