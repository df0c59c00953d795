"""Models of the port: the decoder-only transformer (dense path) and
ResNet-20 (the paper's test model)."""
from repro_torch.models.transformer import Model, make_model

__all__ = ["Model", "make_model"]
