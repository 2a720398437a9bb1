"""repro_torch.launch — entry points (``launch.train``)."""
