"""Typed exceptions (reference util/exceptions.hpp)."""


class SingularCovarianceData(ValueError):
    """Covariance of the data subset is singular / not positive-definite
    (reference util/exceptions.hpp: singular_covariance_data)."""
