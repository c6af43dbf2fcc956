from .dataframe import Column, DataFrame
from .crossvalidation import CrossValidation, HoldOut

__all__ = ["Column", "DataFrame", "CrossValidation", "HoldOut"]
