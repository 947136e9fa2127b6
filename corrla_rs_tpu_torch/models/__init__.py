"""Fitted models of the port: PCA and POD."""
