"""Search callbacks (reference learning/algorithms/callbacks/callback.hpp:14,
save_model.hpp:8-30). Copied from
``pybnesian_tpu/learning/algorithms/callbacks.py``."""

from __future__ import annotations

import os

__all__ = ["Callback", "SaveModel"]


class Callback:
    def call(self, model, operator, score, iteration) -> None:
        raise NotImplementedError


class SaveModel(Callback):
    """Writes a pickle of the model at every iteration — per-iteration
    checkpointing of the search."""

    def __init__(self, folder_name: str):
        self.folder_name = folder_name
        os.makedirs(folder_name, exist_ok=True)

    def call(self, model, operator, score, iteration) -> None:
        model.save(os.path.join(self.folder_name, f"{iteration:06d}"))
