"""Typed option system (reference: src/base/Option.h:53-141).

An ``Option`` carries a name, help text, a value and whether the user ever
set it; an ``OptionDB`` is the registry.  Unlike the reference's four
parallel template instantiations we keep one class with a python type tag —
the semantics (find-by-name, was-ever-used tracking, help dump) match.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Option:
    __slots__ = ("name", "otype", "help", "value", "default", "was_set")

    def __init__(self, name: str, otype: type, help_text: str, default: Any):
        self.name = name
        self.otype = otype
        self.help = help_text
        self.default = default
        self.value = default
        self.was_set = False

    def set(self, value: Any) -> None:
        if self.otype is bool and isinstance(value, str):
            value = value.strip().lower() in ("1", "true", "yes", "on")
        else:
            value = self.otype(value)
        self.value = value
        self.was_set = True

    def __repr__(self) -> str:  # pragma: no cover
        return f"Option({self.name}={self.value!r})"


class OptionDB:
    """Registry of options, mirrors reference OptionDB (Option.h:141)."""

    def __init__(self) -> None:
        self._opts: Dict[str, Option] = {}

    def insert(self, name: str, otype: type, help_text: str, default: Any) -> Option:
        opt = Option(name, otype, help_text, default)
        self._opts[name] = opt
        return opt

    def find(self, name: str) -> Optional[Option]:
        return self._opts.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._opts

    def __iter__(self) -> Iterator[Option]:
        return iter(self._opts.values())

    # convenience typed accessors --------------------------------------
    def get(self, name: str) -> Any:
        opt = self._opts.get(name)
        if opt is None:
            raise KeyError(f"unknown option: {name}")
        return opt.value

    def set(self, name: str, value: Any) -> None:
        opt = self._opts.get(name)
        if opt is None:
            raise KeyError(f"unknown option: {name}")
        opt.set(value)

    def write_help(self, write: Callable[[str], Any]) -> None:
        for name in sorted(self._opts):
            o = self._opts[name]
            write(f"  --{name:<28} {o.help} (default: {o.default!r})\n")
