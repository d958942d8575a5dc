"""Name → object registries with case-insensitive aliases and did-you-mean
suggestions (a copy of the JAX package's ``utils/registry.py``: the port
imports nothing of that package)."""

from __future__ import annotations

import difflib
from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """A case-insensitive name → factory mapping with alias support."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}
        self._canonical: Dict[str, str] = {}  # lowercase -> canonical name

    def register(self, name: str, obj: Any = None, *, aliases: Iterable[str] = ()):
        """Register ``obj`` under ``name`` (and aliases).  Usable as decorator."""

        def _do(o):
            for n in (name, *aliases):
                key = n.lower()
                if key in self._canonical and self._entries[self._canonical[key]] is not o:
                    raise ValueError(f"duplicate {self.kind} name: {n!r}")
                self._canonical[key] = name
                self._entries.setdefault(name, o)
            self._entries[name] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def __contains__(self, name: str) -> bool:
        return isinstance(name, str) and name.lower() in self._canonical

    def get(self, name: str) -> Any:
        key = name.lower()
        if key not in self._canonical:
            hint = self.suggest(name)
            extra = f" Did you mean {hint!r}?" if hint else ""
            raise KeyError(
                f"unknown {self.kind} {name!r}.{extra} "
                f"Known: {sorted(self._entries)}"
            )
        return self._entries[self._canonical[key]]

    def suggest(self, name: str) -> Optional[str]:
        matches = difflib.get_close_matches(name.lower(), list(self._canonical), n=1)
        if matches:
            return self._canonical[matches[0]]
        return None

    def names(self):
        return sorted(self._entries)
