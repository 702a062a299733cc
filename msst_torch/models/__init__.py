"""Estimator pipelines of the port."""
