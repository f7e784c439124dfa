"""Small bounded LRU used by the eval caches (port of
``tpugan/utils/cache.py``).

One implementation for both the real-feature cache (``eval/evaluate.py``)
and the extractor cache (``eval/features.py``): entries are tens of MB
(features) to ~100 MB (InceptionV3's weights), so a long-lived process
needs an eviction policy, not a plain dict.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional


class BoundedCache:
    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()

    def get(self, key: Hashable) -> Optional[Any]:
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
