"""Synthetic content/style data and federated splits (port of
``repro.data``)."""
