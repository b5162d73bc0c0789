from .wigner import real_wigner_3j
from .spherical import sh_coefficients, spherical_harmonics

__all__ = ["real_wigner_3j", "sh_coefficients", "spherical_harmonics"]
