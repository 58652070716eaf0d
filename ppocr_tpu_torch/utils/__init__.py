from .checkpoint import load_params_npz

__all__ = ["load_params_npz"]
