from .callbacks import Callback, SaveModel
from .hillclimbing import GreedyHillClimbing, hc

__all__ = ["GreedyHillClimbing", "hc", "Callback", "SaveModel"]
