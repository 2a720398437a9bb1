"""repro_torch.models — the dense and MoE transformer families (training
path)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
