"""Bayesian filtering (port of ``fusion/``): unscented pose fusion
(:mod:`.ukf`), covariance (EKF) and UdU square-root filters
(:mod:`.kalman`), and the landmark-SLAM schemes, EKF-SLAM and fastSLAM
(:mod:`.slam_schemes`). The SIR particle scheme lives in
:mod:`..localization.particle_filter`."""

from . import kalman, slam_schemes, ukf
from .kalman import KalmanState, UdState, udu_factorize
from .slam_schemes import EkfSlamState, FastSlamState
from .ukf import FusionInputs, UkfState, fusion_step

__all__ = [
    "kalman",
    "slam_schemes",
    "ukf",
    "KalmanState",
    "UdState",
    "udu_factorize",
    "EkfSlamState",
    "FastSlamState",
    "FusionInputs",
    "UkfState",
    "fusion_step",
]
