"""chip_smoke.py, the GPU gate: its refusal to run without a GPU (CPU), and
the gate itself (marked `gpu`; skips without a card).

The suite's own process stays pinned to the CPU (conftest): the gate runs in
a child process, which is then the only process on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, CHIP_SMOKE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _last_json(r.stdout)["ok"] is False


def _has_nvidia_gpu():
    if shutil.which("nvidia-smi") is None:
        return False
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                       timeout=60)
    return r.returncode == 0 and "GPU" in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    if not _has_nvidia_gpu():
        pytest.skip("no NVIDIA GPU (nvidia-smi finds none)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    r = subprocess.run([sys.executable, CHIP_SMOKE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = _last_json(r.stdout)
    assert res["ok"] is True
    assert res["device"]["platform"] == "gpu"
