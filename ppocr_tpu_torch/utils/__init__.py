from .checkpoint import load_params_npz, restore_train_state, save_params_npz, save_train_state

__all__ = ["load_params_npz", "restore_train_state", "save_params_npz", "save_train_state"]
