from .schema import TensorFeatureInfo, TensorFeatureSource, TensorMap, TensorSchema

__all__ = ["TensorFeatureInfo", "TensorFeatureSource", "TensorMap", "TensorSchema"]
