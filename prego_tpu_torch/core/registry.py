"""Component registry.

Parity surface: the reference's builder/registry layer
(step_recognition/utils/registry.py:1-19) — a dict with a ``register``
decorator asserting on duplicate names. Here registries are typed, support
multiple aliases per entry, and give actionable error messages listing
known names.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named mapping from string keys to components (classes/functions)."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, T] = {}

    def register(self, *names: str) -> Callable[[T], T]:
        """Decorator registering an object under one or more names."""
        if not names:
            raise ValueError(f"registry {self.name!r}: at least one name required")

        def _register(obj: T) -> T:
            for n in names:
                if n in self._entries:
                    raise KeyError(
                        f"registry {self.name!r}: duplicate name {n!r} "
                        f"(already bound to {self._entries[n]!r})"
                    )
                self._entries[n] = obj
            return obj

        return _register

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<empty>"
            raise KeyError(
                f"registry {self.name!r}: unknown name {name!r}; known: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()


# Registries of the port (the JAX package's builder layer, restricted to
# the components ported so far).
MODELS: Registry = Registry("models")
EVALUATORS: Registry = Registry("evaluators")
LLMS: Registry = Registry("llms")
