"""Train/test splitters (counterpart of ``replay_tpu/splitters``), without
pandas: so far :class:`LastNSplitter`; the other strategies come with
ROADMAP.md queue 1, item 11."""

from .base import Splitter, SplitterReturnType
from .strategies import LastNSplitter

__all__ = ["LastNSplitter", "Splitter", "SplitterReturnType"]
