from .model import TwoTower
from .reader import FeaturesReader

__all__ = ["FeaturesReader", "TwoTower"]
