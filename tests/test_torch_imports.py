"""The port stands alone: importing every module of
reflectance_filtering_tpu_torch pulls in neither JAX nor the JAX package,
and touches no CUDA."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import reflectance_filtering_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import torch
print(json.dumps({
    "imported": names,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib",
                                             "reflectance_filtering_tpu")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert not out["cuda_initialized"]
    for name in ("cli.decompose", "cli.filter", "cli.train",
                 "data.loader", "losses.losses", "losses.whdr",
                 "models.caffe_io", "models.networks", "models.recover",
                 "ops._build", "ops.bilateral", "ops.bilateral_joint_kernel",
                 "ops.bilateral_kernel", "ops.box_kernel",
                 "ops.boxfilter", "ops.cnn_kernel", "ops.cnn_train_kernel",
                 "ops.guided", "ops.guided_kernel", "ops.whdr_gather",
                 "train.checkpoint", "train.description", "train.loop",
                 "train.monitors", "train.predict", "utils.image",
                 "utils.serving", "utils.testimages"):
        assert "reflectance_filtering_tpu_torch." + name in out["imported"]
