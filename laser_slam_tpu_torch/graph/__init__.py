"""Pose-graph backend: submaps, place recognition, loop closure, solve."""
