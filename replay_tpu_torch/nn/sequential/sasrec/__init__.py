from .model import SasRec, SasRecBody
from .ti_model import TiSasRec
from .transformer import DiffTransformerLayer, SasRecTransformerLayer

__all__ = ["DiffTransformerLayer", "SasRec", "SasRecBody", "SasRecTransformerLayer", "TiSasRec"]
