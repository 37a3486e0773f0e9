"""PyTorch port: the package's examples run (``python -m
cylinder_pose_estimation_tpu_torch.examples.<name> --device cpu``), without
JAX, and print what they promise."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module: str):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    script = ("import sys; sys.modules['jax'] = None; import runpy; "
              f"sys.argv = ['{module}', '--device', 'cpu']; runpy.run_module('{module}', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


def test_quickstart_runs():
    out = _run("cylinder_pose_estimation_tpu_torch.examples.quickstart")
    assert out.returncode == 0, out.stderr[-2000:]
    for line in ("loaded stereo rig", "cylinder fit: axis error", "grid JSON round trip: 81 points",
                 "detect_grid (subpixel_refine=True): 35 grid points, ok = True", "registration:"):
        assert line in out.stdout, out.stdout
    err = float(out.stdout.split("translation error ")[1].split()[0])
    assert err < 1.0


@pytest.mark.slow
def test_streaming_serving_runs():
    out = _run("cylinder_pose_estimation_tpu_torch.examples.streaming_serving")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok 12/12" in out.stdout, out.stdout
