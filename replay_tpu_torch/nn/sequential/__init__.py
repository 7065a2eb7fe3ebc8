from .sasrec.model import SasRec, SasRecBody

__all__ = ["SasRec", "SasRecBody"]
