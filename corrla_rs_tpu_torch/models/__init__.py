"""Fitted models of the port: PCA, POD, DMD/DMDc, active subspaces and the
ROM models on the DMD core."""
