"""Frozen copies of the plain PyTorch modules of the port that the cells'
timed paths run, kept with the benchmark so that no change to the
program changes its yardstick.

Each file is the port's module as it stood when the benchmark was
written, with these changes: ``ops/odometry`` runs pass 1 as the host
loop of plain PSM matches (no CUDA kernel, no pairwise odometry) and
returns the solver iterations of each match beside its result, and can
run pass 1 as lanes side by side (``chain_lanes``);
``ops/psm.match_psm`` counts those iterations; ``ops/icp_points``
factors and inverts its small matrices in float32 when run in a lower
precision, which torch's factorizations do not take. Nothing here
imports the program."""
