from .ops import relaxed_deletemin
from .ref import relaxed_deletemin_ref, relaxed_walk_model

__all__ = ["relaxed_deletemin", "relaxed_deletemin_ref",
           "relaxed_walk_model"]
