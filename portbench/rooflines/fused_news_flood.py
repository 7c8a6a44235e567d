"""The news kernel's roofline in the flood cell: the same launch function,
trace kernel, bytes and operations as rooflines/fused_news.py."""

from rooflines.fused_news import KERNEL, TARGET, capture, cost  # noqa: F401
