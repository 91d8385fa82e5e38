"""Batched kernel-threshold sweep (BASELINE config 2) on the real data."""

import numpy as np
import pytest

from jaxvo.config import EngineConfig
from jaxvo.engine.eval import evaluate, metrics_dict
from jaxvo.engine.vo import run_sequence, run_threshold_sweep


@pytest.mark.slow
def test_sweep_matches_individual_runs(sequence):
    thresholds = [1000.0, 3000.0, 10000.0]
    states, logs, poses = run_threshold_sweep(sequence, thresholds)
    assert poses.shape == (3, 121, 4, 4)

    # NOTE: bitwise pose equality with the unbatched run is not expected —
    # vmap changes fusion order and the monocular feedback loop is
    # numerically chaotic (see the fp-order analysis in ops/picp.py
    # sentinel comment); the gate is metric-level.
    m_ref = metrics_dict(evaluate(np.asarray(run_sequence(sequence)[2]), sequence.gt_pose))
    m_3000 = metrics_dict(evaluate(np.asarray(poses[1]), sequence.gt_pose))
    assert abs(m_3000["trans_err_mean"] - m_ref["trans_err_mean"]) < 0.1

    # thresholds 3000/10000 track well; 1000 legitimately loses track in the
    # sparse mid-sequence section — which is exactly why the reference's
    # README:9 settled on 3000
    for i, t in enumerate(thresholds):
        m = metrics_dict(evaluate(np.asarray(poses[i]), sequence.gt_pose))
        assert np.isfinite(m["trans_err_mean"]), (t, m)
        if t >= 3000:
            assert m["trans_err_mean"] < 0.5, (t, m)
        assert int(states.map_count[i]) > 400
