"""Save/load helpers (reference util/pickle.hpp:11-21, util/pickle.cpp:5-11).

Every public object exposes ``save(filename)``; the module-level ``load``
reads any saved object back. Files get a ``.pickle`` suffix when none is
given, matching the reference."""

from __future__ import annotations

import pickle


def _with_suffix(filename: str) -> str:
    return filename if filename.endswith(".pickle") else filename + ".pickle"


def save_object(obj, filename: str) -> None:
    with open(_with_suffix(filename), "wb") as f:
        pickle.dump(obj, f)


def load(filename: str):
    try:
        f = open(filename, "rb")
    except FileNotFoundError:
        f = open(_with_suffix(filename), "rb")
    with f:
        return pickle.load(f)
