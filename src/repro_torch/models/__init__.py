"""Dense GQA transformer: schema, layers, attention, stack, facade."""
from repro_torch.models.model import Model

__all__ = ["Model"]
