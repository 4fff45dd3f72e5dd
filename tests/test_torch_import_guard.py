"""paimon_tpu_torch imports neither jax nor any module of paimon_tpu.

The check runs in a subprocess because this test session's conftest
imports jax in-process.  Exact: a module is either loaded or not.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import paimon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paimon_tpu_torch.__path__, "paimon_tpu_torch.")]
for name in names:
    __import__(name)
from paimon_tpu_torch import native
lib = native.load()
bad = sorted(m for m in sys.modules
             if m == "jax" and sys.modules[m] is not None
             or m.startswith("jax.")
             or m == "paimon_tpu" or m.startswith("paimon_tpu."))
with open("/proc/self/maps") as f:
    libs = sorted({line.split()[-1] for line in f
                   if line.rstrip().endswith(".so")})
print(json.dumps({"modules": names, "bad": bad, "libs": libs,
                  "native": None if lib is None else lib._name}))
"""


def _probe():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_reference_package_loaded():
    out = _probe()
    assert out["bad"] == []
    # every module of the slice was imported, not just the package root
    for name in ("paimon_tpu_torch.ops.kernels", "paimon_tpu_torch.ops.merge",
                 "paimon_tpu_torch.ops.merge_stream",
                 "paimon_tpu_torch.compact.manager",
                 "paimon_tpu_torch.table.table",
                 "paimon_tpu_torch.ops.diff",
                 "paimon_tpu_torch.table.stream_scan",
                 "paimon_tpu_torch.snapshot.consumer_manager",
                 "paimon_tpu_torch.snapshot.changelog_manager",
                 "paimon_tpu_torch.ops.decode",
                 "paimon_tpu_torch.ops.ovc",
                 "paimon_tpu_torch.format.rawpage",
                 "paimon_tpu_torch.fs.caching",
                 "paimon_tpu_torch.native",
                 "paimon_tpu_torch.metrics",
                 "paimon_tpu_torch.obs.trace",
                 "paimon_tpu_torch.obs.flight",
                 "paimon_tpu_torch.parallel.fault",
                 "paimon_tpu_torch.parallel.packing",
                 "paimon_tpu_torch.parallel.sharded_merge",
                 "paimon_tpu_torch.parallel.mesh_engine",
                 "paimon_tpu_torch.parallel.sharded_compact",
                 "paimon_tpu_torch.parallel.rescale",
                 "paimon_tpu_torch.parallel.dryrun",
                 "paimon_tpu_torch.utils.deadline",
                 "paimon_tpu_torch.fs.resilience",
                 "paimon_tpu_torch.obs.slo",
                 "paimon_tpu_torch.obs.export",
                 "paimon_tpu_torch.index.bloom",
                 "paimon_tpu_torch.lookup",
                 "paimon_tpu_torch.lookup.sst",
                 "paimon_tpu_torch.lookup.local_query",
                 "paimon_tpu_torch.service",
                 "paimon_tpu_torch.service.admission",
                 "paimon_tpu_torch.service.brownout",
                 "paimon_tpu_torch.service.async_server",
                 "paimon_tpu_torch.service.delta",
                 "paimon_tpu_torch.service.query_service"):
        assert name in out["modules"]


def test_native_library_is_the_ports_own():
    """The port loads the C library it built from its own copy of the
    sources into paimon_tpu_torch/_build/, never paimon_tpu/native/'s."""
    out = _probe()
    build = os.path.join(REPO, "paimon_tpu_torch", "_build")
    assert out["native"] == os.path.join(build, "_paimon_torch_native.so")
    loaded = [p for p in out["libs"] if "paimon" in os.path.basename(p)]
    assert out["native"] in loaded
    assert not [p for p in loaded
                if os.path.join("paimon_tpu", "native") in p]


@pytest.mark.parametrize("name, expected", [
    ("paimon_tpu", True), ("paimon_tpu.ops", True),
    ("paimon_tpu_torch", False), ("paimon_tpu_torch.ops", False)])
def test_reference_module_name_check(name, expected):
    """The guard's prefix test must not mistake the port for the
    reference ("paimon_tpu_torch".startswith("paimon_tpu") is true)."""
    assert (name == "paimon_tpu" or name.startswith("paimon_tpu.")) \
        is expected


def test_entry_points_raise_without_cuda(tmp_path):
    """device=None means cuda; without a card the port raises instead of
    running on the CPU."""
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.device import resolve_device
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    schema = (Schema.builder().column("id", BigIntType(False))
              .primary_key("id").options({"bucket": "1"}).build())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FileStoreTable.create(str(tmp_path / "t"), schema)
    assert not (tmp_path / "t").exists()
    FileStoreTable.create(str(tmp_path / "t"), schema, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FileStoreTable.load(str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
