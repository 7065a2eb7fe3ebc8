from .prefetch import DevicePrefetcher, prefetch
from .schema import TensorFeatureInfo, TensorFeatureSource, TensorMap, TensorSchema

__all__ = ["DevicePrefetcher", "TensorFeatureInfo", "TensorFeatureSource", "TensorMap", "TensorSchema", "prefetch"]
