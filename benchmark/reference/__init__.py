"""The plain reference of the inspection chain: OpenCV's semantics restated
in plain PyTorch (any device) and NumPy, with no kernel and nothing of the
port. :func:`benchmark.reference.chain.inspect_frames` is the entry."""
