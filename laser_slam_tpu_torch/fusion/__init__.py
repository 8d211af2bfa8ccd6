"""Bayesian filtering: unscented pose fusion (:mod:`.ukf`). The SIR
particle scheme lives in :mod:`..localization.particle_filter`."""

from . import ukf
from .ukf import FusionInputs, UkfState, fusion_step

__all__ = ["ukf", "FusionInputs", "UkfState", "fusion_step"]
