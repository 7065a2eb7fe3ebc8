from .bert4rec.model import Bert4Rec, Bert4RecBody
from .sasrec.model import SasRec, SasRecBody
from .twotower.model import TwoTower
from .twotower.reader import FeaturesReader

__all__ = ["Bert4Rec", "Bert4RecBody", "FeaturesReader", "SasRec", "SasRecBody", "TwoTower"]
