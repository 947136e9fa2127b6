"""The multi-device layer on ``torch.distributed``: the device mesh, the
sharded randomized SVD and HOSVD, and the chain-sharded samplers.

Counterpart of ``corrla_rs_tpu/parallel``. Every entry point here is SPMD:
each rank of the mesh makes the same call (see ``parallel.mesh``).
"""
