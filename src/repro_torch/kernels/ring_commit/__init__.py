from .ops import ring_commit
from .ref import ring_commit_ref

__all__ = ["ring_commit", "ring_commit_ref"]
