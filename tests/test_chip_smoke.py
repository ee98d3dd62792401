"""chip_smoke.py's phases on the CPU at tiny budgets, and its device check.

The smoke itself runs on the GPU; here the phase functions are called
directly (the device check lives only in main), the Sinkhorn kernel in
interpret mode.
"""

import os
import subprocess
import sys

import numpy as np

import chip_smoke
from __graft_entry__ import _compile_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_phase_tiny_budgets():
    # the replay program only (one compile): run_chunked and _step_jit have
    # their own tests in test_pipeline.py
    rep = chip_smoke.phase_main(_compile_config(), n_scans=4, n_points=1024,
                                chunk=0, n_steps=0)
    assert rep["failures"] == [], rep["failures"]
    assert np.isfinite(rep["ate"]["trans_m"])
    # the CPU replays deterministically: the second replay repeats the first
    assert rep["replay_max_abs_dpose_run1_vs_run2"] == 0.0
    assert "first_chunked_s" not in rep and "first_steps_s" not in rep


def test_kernel_phase_interpret():
    rep = chip_smoke.phase_kernel(widths=(96,), n_hyp=2, interpret=True)
    assert rep["ok"], rep
    assert set(rep["cases"]) == {"N=96 alone", "N=96 vmap2"}


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""
