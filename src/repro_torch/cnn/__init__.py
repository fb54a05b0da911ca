from .registry import CNN_NAMES, DEEP_CNN_NAMES, TABLE_III, get_cnn, total_params

__all__ = ["CNN_NAMES", "DEEP_CNN_NAMES", "TABLE_III", "get_cnn",
           "total_params"]
