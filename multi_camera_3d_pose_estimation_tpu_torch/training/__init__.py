"""Training helpers of the port; so far the flip permutation that flip-TTA uses."""

from .augment import flip_permutation

__all__ = ["flip_permutation"]
