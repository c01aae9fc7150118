from .ops import gather_pages, gather_pages_async
from .ref import gather_pages_ref

__all__ = ["gather_pages", "gather_pages_async", "gather_pages_ref"]
