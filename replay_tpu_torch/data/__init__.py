from .schema import FeatureHint, FeatureSource, FeatureType

__all__ = ["FeatureHint", "FeatureSource", "FeatureType"]
