from .model import Bert4Rec, Bert4RecBody

__all__ = ["Bert4Rec", "Bert4RecBody"]
