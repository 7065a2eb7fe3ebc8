from .compiled import CompiledInference, params_mismatch

__all__ = ["CompiledInference", "params_mismatch"]
