"""Interest-point features on 2D laser scans (port of ``features/``):
multiscale blob detection on the range curve, a polar descriptor, the
symmetric-χ² descriptor distance and a batched-hypothesis RANSAC SE(2)
matcher. Everything is fixed-shape (``K`` features per scan with
validity masks) and batched along a leading axis."""

from .descriptor import describe_features, descriptor_distance
from .detector import FeatureSet, detect_features
from .ransac import (
    FeatureMatchResult,
    draw_hypotheses,
    match_features,
    match_features_at,
)

__all__ = [
    "FeatureSet",
    "detect_features",
    "describe_features",
    "descriptor_distance",
    "FeatureMatchResult",
    "draw_hypotheses",
    "match_features",
    "match_features_at",
]
