"""Variational MI bounds, critics, estimators and the kNN conditional-product sampler."""
