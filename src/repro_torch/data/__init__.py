"""Synthetic datasets (numpy copies of ``repro.data``)."""
