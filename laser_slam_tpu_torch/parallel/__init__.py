"""Distributed SLAM compute over ``torch.distributed`` (port of
``parallel/``): meshes, sharded matching, the edge-sharded solve."""
