"""The port stands alone: ``geomesa_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and entry points never fall back
to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # xdist workers share the host's cores

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "geomesa_tpu_torch"

_WORKLOAD = r"""
import sys
import numpy as np
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.process.density import density
from geomesa_tpu_torch.store.direct import BatchStore
from geomesa_tpu_torch import convert, kernels
from geomesa_tpu_torch.kernels import _build

sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
rng = np.random.default_rng(0)
n = 500
cols = {
    "count": rng.integers(0, 10, n),
    "dtg": rng.integers(1_577_836_800_000, 1_580_515_200_000, n),
    "geom": rng.uniform(-50, 50, (n, 2)),
}
batch = FeatureBatch.from_columns(sft, cols)
di = DeviceIndex(BatchStore(batch), "t", z_planes=True, device="cpu")
q = "BBOX(geom, -10, -10, 30, 30) AND dtg DURING 2020-01-03T00:00:00Z/2020-01-09T00:00:00Z"
assert di.count(q, loose=True) >= di.count(q) == len(di.query(q))
inter = DeviceIndex(BatchStore(batch), "t", z_planes=True, dim_planes=False, device="cpu")
assert inter.count(q, loose=True) == di.count(q, loose=True)
count_fn, ops = inter.loose_scan_kernel(q)
assert int(count_fn(*ops)) == inter.count(q, loose=True)
cols[VIS_COLUMN] = rng.choice(["", "A", "A&B"], n)
store = BatchStore(FeatureBatch.from_columns(sft, cols))
ldi = DeviceIndex(store, "t", device="cpu")
env = Envelope(-50, -50, 50, 50)
grid = density(store, "t", q, env, 32, 16, device_index=ldi, auths=("A",))
assert grid.sum() == ldi.count(q, auths=("A",)) < di.count(q)
seq = ldi.stats(q, 'Count();MinMax("count");Histogram("count",10,0,10)', auths=("A",))
assert seq.to_json()[0]["count"] == grid.sum()
assert not _build._libs  # CPU tensors never build or load a kernel
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu."))
print("LOADED", bad)
"""


def test_port_workload_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMESA_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"  # the child's torch pool, as the cap above
    out = subprocess.run(
        [sys.executable, "-c", _WORKLOAD], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+geomesa_tpu\b(?!_torch)|from\s+geomesa_tpu(\.|\s)(?!_torch))"
    r"|geomesa_tpu\.(?!_torch)",
    re.M,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_jax_imports():
    for bad in ("import jax", "from jax import numpy", "import geomesa_tpu",
                "from geomesa_tpu.ops import zscan", "x = geomesa_tpu.ops"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import geomesa_tpu_torch", "from geomesa_tpu_torch.ops import zscan"):
        assert not _FORBIDDEN.search(ok), ok


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from geomesa_tpu_torch.device import resolve_device
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.store.direct import BatchStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    sft = SimpleFeatureType.create("t", "*geom:Point:srid=4326")
    store = BatchStore(FeatureBatch.from_columns(sft, {"geom": np.zeros((4, 2))}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex(store, "t")
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.process.density import density

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        density(store, "t", "INCLUDE", Envelope(-1, -1, 1, 1), 4, 4)  # the store path
    assert density(store, "t", "INCLUDE", Envelope(-1, -1, 1, 1), 4, 4, device="cpu").sum() == 4


def test_kernel_build_needs_nvcc(monkeypatch):
    from geomesa_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
