"""Reference numbers of the JAX package's ICP-verified SLAM branch
(``slam_offline(SlamConfig(use_correlative=False, use_submaps=...))``) on
the synthetic log ``tools/synthetic_log.py`` writes with its defaults
(2672 scans, seed 0), on the CPU.

    python tools/icp_branch_reference.py front
        JAX's own front end (preprocess + keyframe odometry): writes its
        odometry poses and step flags to baselines/jax_synthetic_front.npz
        and prints the branch's ATE from it, with submaps off and on.
    python tools/icp_branch_reference.py from FRONT.npz
        The branch's rounds from another front end's odometry (``poses``,
        ``weak``, ``fracture``), e.g. baselines/port_card_synthetic_front.npz,
        the PyTorch port's keyframe odometry on the card (``chip_smoke.py``
        writes it to build/slam_icp_card_front.npz and holds its run to the
        committed copy). The scans are JAX's preprocessing of the log, which
        the port's preprocessing on the card matches bit for bit. Prints
        the ATE with submaps off and on.

The ATE is the rmse after SE(2) alignment against the log's ground truth.
This script runs the JAX package (it is the reference); the port and
``chip_smoke.py`` only read what it wrote.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
FRONT = os.path.join(ROOT, "baselines", "jax_synthetic_front.npz")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import synthetic_log as synth
    from laser_slam_tpu.eval.metrics import ate
    from laser_slam_tpu.graph.submap import build_submaps
    from laser_slam_tpu.io.carmen import read_carmen
    from laser_slam_tpu.ops.odometry import odometry_keyframe
    from laser_slam_tpu.ops.preprocess import preprocess
    from laser_slam_tpu.runtime import slam

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "synthetic.log")
        ranges, gt, ts = synth.synthetic_log()
        synth.write_carmen(path, ranges, gt, ts)
        log = read_carmen(path)
    scans = preprocess(jnp.asarray(log.ranges), log.model)
    if argv[:1] == ["front"]:
        odo = odometry_keyframe(log.model, scans, timestamps=log.timestamps)
        front = dict(poses=np.asarray(odo.poses), weak=np.asarray(odo.weak),
                     fracture=np.asarray(odo.fracture))
        np.savez_compressed(FRONT, **front)
        print(f"odometry poses and flags -> {FRONT}")
    elif argv[:1] == ["from"] and len(argv) == 2:
        dump = np.load(argv[1])
        front = {k: dump[k] for k in ("poses", "weak", "fracture")}
    else:
        raise SystemExit(__doc__)
    gt = jnp.asarray(log.gt_pose)
    poses = jnp.asarray(front["poses"])
    print(f"jax {jax.__version__}; odometry ATE {float(ate(poses, gt).rmse)!r} m")
    for use_submaps in (False, True):
        cfg = slam.SlamConfig(use_correlative=False, use_submaps=use_submaps)
        t0 = time.perf_counter()
        (_, anchor_idx, anchor_scans, anchor_poses, rel_seq, seq_w, _) = slam._frontend_post(
            cfg, scans, poses, jnp.asarray(front["weak"]), jnp.asarray(front["fracture"]))
        submaps = (build_submaps(log.model, scans, poses, cfg.anchor_stride, cfg.submap_points)
                   if use_submaps else None)
        round_fn = jax.jit(lambda a, p, r, radius, w, sm: slam._loop_round(
            log.model, cfg, a, p, r, radius, w, sm))
        for r in range(cfg.rounds):
            anchor_poses, n_loops, _ = round_fn(anchor_scans, anchor_poses, rel_seq,
                                                jnp.asarray(cfg.loop_radius * 2.0 ** r, jnp.float32),
                                                seq_w, submaps)
        final = slam._reattach(cfg, anchor_poses, poses)
        print(f"use_submaps={use_submaps}: loops kept in the last round {int(n_loops)}, ATE "
              f"{float(ate(final, gt).rmse)!r} m ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
