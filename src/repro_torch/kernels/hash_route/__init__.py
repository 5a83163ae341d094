from .ops import hash_route
from .ref import hash_route_ref

__all__ = ["hash_route", "hash_route_ref"]
