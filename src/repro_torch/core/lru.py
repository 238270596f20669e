"""One bounded LRU mapping for every host-side memo in the package (flat-IT
builds, compiled plans), so the eviction/recency rules live in exactly one
place."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class BoundedLRU:
    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()

    def get(self, key: Hashable, default: Any = None) -> Any:
        try:
            val = self._d[key]
        except KeyError:
            return default
        self._d.move_to_end(key)
        return val

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d
