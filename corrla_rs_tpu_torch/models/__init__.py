"""Fitted models of the port: PCA, POD, DMD/DMDc and active subspaces."""
