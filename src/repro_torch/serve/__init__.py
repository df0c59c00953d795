"""Serving of the port: the batched prefill + decode loop
(:mod:`repro_torch.serve.serving`)."""
from repro_torch.serve.serving import generate

__all__ = ["generate"]
