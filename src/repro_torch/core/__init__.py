"""repro_torch.core — the RMA window layer (``core.rma``)."""
