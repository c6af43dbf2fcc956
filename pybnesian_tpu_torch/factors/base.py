"""Factor abstractions: FactorType / Factor pair, Arguments, Assignment.

Rebuild of reference factors/factors.hpp:28-198, factors/arguments.hpp:16-36
and factors/assignment.hpp. In the reference these are pybind11-trampolined
C++ classes; here they are plain Python ABCs, so user subclassing (the
reference's extension contract, pybindings_factors.cpp:28-145) is direct.
"""

from __future__ import annotations

from typing import Sequence

__all__ = [
    "FactorType",
    "Factor",
    "UnknownFactorType",
    "Args",
    "Kwargs",
    "Arguments",
    "Assignment",
]


class FactorType:
    """Identity token + factory for a factor class
    (reference factors/factors.hpp:28-116). Identity is the Python class:
    two instances of the same FactorType subclass compare equal."""

    _singleton = None

    def __new__(cls, *args, **kwargs):
        # singleton per subclass unless the subclass carries state
        if cls._default_singleton() and cls._singleton is not None:
            return cls._singleton
        inst = super().__new__(cls)
        if cls._default_singleton():
            cls._singleton = inst
        return inst

    @classmethod
    def _default_singleton(cls) -> bool:
        return True

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(type(self))

    def new_factor(self, model, variable, evidence, *args, **kwargs) -> "Factor":
        # NotImplementedError subclasses RuntimeError; the message mirrors
        # pybind11's pure-virtual diagnostic the reference emits
        # (factor_type_test.py asserts on it)
        raise NotImplementedError(
            'Tried to call pure virtual function "FactorType::new_factor"'
        )

    def ToString(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()

    # pickling: singletons reduce to the class
    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        pass

    def __reduce__(self):
        if type(self)._default_singleton():
            return (type(self), ())
        return super().__reduce__()


class UnknownFactorType(FactorType):
    """Sentinel for heterogeneous networks before type resolution
    (reference factors/unknown_factor.hpp:10)."""

    def new_factor(self, model, variable, evidence, *args, **kwargs):
        raise ValueError("UnknownFactorType cannot create factors")


class Factor:
    """Conditional probability distribution P(variable | evidence)
    (reference factors/factors.hpp:118-198)."""

    # Subclasses WITHOUT __slots__ (including user extension classes) still
    # get an instance __dict__ automatically; slotting the base only makes
    # the two universal attributes cheap and lets fully-slotted subclasses
    # (LinearGaussianCPD) skip the per-instance dict entirely.
    __slots__ = ("_variable", "_evidence")

    def __init__(self, variable: str, evidence: Sequence[str] = ()):  # noqa: D401
        self._variable = str(variable)
        self._evidence = [str(e) for e in evidence]

    def variable(self) -> str:
        return self._variable

    def evidence(self) -> list[str]:
        return list(self._evidence)

    # pure-virtual surface: messages mirror pybind11's diagnostic so code
    # written against the reference's trampolines sees the same text
    def fitted(self) -> bool:
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::fitted"'
        )

    def type(self) -> FactorType:
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::type"'
        )

    def data_type(self):
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::data_type"'
        )

    def fit(self, df) -> None:
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::fit"'
        )

    def logl(self, df):
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::logl"'
        )

    def slogl(self, df) -> float:
        import numpy as np

        return float(np.nansum(self.logl(df)))

    def sample(self, n: int, evidence_values=None, seed: int | None = None):
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::sample"'
        )

    def ToString(self) -> str:
        raise NotImplementedError(
            'Tried to call pure virtual function "Factor::ToString"'
        )

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()

    def save(self, filename: str) -> None:
        from ..utils.pickle import save_object

        save_object(self, filename)


class Args:
    """Positional construction args bundle (reference factors/arguments.hpp)."""

    def __init__(self, *args):
        self.args = args


class Kwargs:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


class Arguments:
    """Per-node / per-factor-type factor construction arguments
    (reference factors/arguments.hpp:16-36). Keys are node names (exact
    match wins) or FactorType instances (wildcard by type)."""

    def __init__(self, mapping: dict | None = None):
        self._map = {}
        for key, value in (mapping or {}).items():
            args, kwargs = (), {}
            if isinstance(value, tuple):
                for item in value:
                    if isinstance(item, Args):
                        args = item.args
                    elif isinstance(item, Kwargs):
                        kwargs = item.kwargs
            elif isinstance(value, Args):
                args = value.args
            elif isinstance(value, Kwargs):
                kwargs = value.kwargs
            self._map[key] = (args, kwargs)

    def args(self, node: str, factor_type: FactorType | None = None):
        """(args, kwargs) for constructing the factor of ``node``; exact node
        name first, then factor-type wildcard, then empty."""
        if node in self._map:
            return self._map[node]
        if factor_type is not None:
            for key, value in self._map.items():
                if isinstance(key, FactorType) and key == factor_type:
                    return value
        return (), {}


class Assignment:
    """Frozen mapping var → (str | float) with set-style hashing
    (reference factors/assignment.hpp:154)."""

    def __init__(self, mapping: dict):
        items = {}
        for key, value in mapping.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                items[str(key)] = float(value)
            else:
                items[str(key)] = str(value)
        self._items = items
        self._frozen = frozenset(items.items())

    def value(self, key: str):
        return self._items[key]

    def __getitem__(self, key: str):
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()

    def size(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        """True when there are no assignments (pybindings_factors.cpp:691)."""
        return not self._items

    def has_variables(self, variables) -> bool:
        """True if every name in ``variables`` is assigned
        (pybindings_factors.cpp:679)."""
        return all(v in self._items for v in variables)

    def insert(self, variable: str, value) -> None:
        """Add an assignment (pybindings_factors.cpp:702)."""
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            self._items[str(variable)] = float(value)
        else:
            self._items[str(variable)] = str(value)
        self._frozen = frozenset(self._items.items())

    def remove(self, variable: str) -> None:
        """Remove an assignment (pybindings_factors.cpp:712)."""
        del self._items[variable]
        self._frozen = frozenset(self._items.items())

    def __iter__(self):
        return iter(self._items.items())

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other) -> bool:
        return isinstance(other, Assignment) and self._frozen == other._frozen

    def __hash__(self) -> int:
        return hash(self._frozen)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k} = {v}" for k, v in sorted(self._items.items()))
        return f"Assignment({inner})"

    def ToString(self) -> str:
        return repr(self)
