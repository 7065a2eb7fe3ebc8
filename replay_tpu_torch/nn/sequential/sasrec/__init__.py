from .model import SasRec, SasRecBody
from .transformer import SasRecTransformerLayer

__all__ = ["SasRec", "SasRecBody", "SasRecTransformerLayer"]
