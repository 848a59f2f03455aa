"""Tools that run the port on the card (``python -m tpu_inspect_torch.tools.<name>``)."""
