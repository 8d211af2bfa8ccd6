"""Pipelines that run the whole system over a log."""
