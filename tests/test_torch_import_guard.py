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
                 "paimon_tpu_torch.parallel.multihost",
                 "paimon_tpu_torch.parallel.distributed",
                 "paimon_tpu_torch.parallel.maintenance_plane",
                 "paimon_tpu_torch.analysis.engine",
                 "paimon_tpu_torch.analysis.model",
                 "paimon_tpu_torch.analysis.rules.hygiene",
                 "paimon_tpu_torch.analysis.rules.drift",
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
                 "paimon_tpu_torch.service.query_service",
                 "paimon_tpu_torch.manifest.index_manifest",
                 "paimon_tpu_torch.core.dynamic_bucket",
                 "paimon_tpu_torch.core.cross_partition",
                 "paimon_tpu_torch.compact.compact_action",
                 "paimon_tpu_torch.index.dv_maintainer",
                 "paimon_tpu_torch.data.casting",
                 "paimon_tpu_torch.schema.schema_manager",
                 "paimon_tpu_torch.snapshot.tag_manager",
                 "paimon_tpu_torch.snapshot.branch_manager",
                 "paimon_tpu_torch.utils.callbacks",
                 "paimon_tpu_torch.maintenance",
                 "paimon_tpu_torch.maintenance.expire",
                 "paimon_tpu_torch.maintenance.fsck",
                 "paimon_tpu_torch.maintenance.repair",
                 "paimon_tpu_torch.maintenance.orphan",
                 "paimon_tpu_torch.maintenance.watermark",
                 "paimon_tpu_torch.maintenance.manifest_compact",
                 "paimon_tpu_torch.maintenance.partition_expire",
                 "paimon_tpu_torch.maintenance.mark_done",
                 "paimon_tpu_torch.maintenance.tag_auto",
                 "paimon_tpu_torch.maintenance.clone",
                 "paimon_tpu_torch.maintenance.migrate",
                 "paimon_tpu_torch.format.blob",
                 "paimon_tpu_torch.format.mosaic",
                 "paimon_tpu_torch.data.variant",
                 "paimon_tpu_torch.stats",
                 "paimon_tpu_torch.table.system",
                 "paimon_tpu_torch.table.format_table",
                 "paimon_tpu_torch.table.object_table",
                 "paimon_tpu_torch.catalog",
                 "paimon_tpu_torch.catalog.catalog",
                 "paimon_tpu_torch.catalog.system",
                 "paimon_tpu_torch.catalog.view",
                 "paimon_tpu_torch.catalog.function",
                 "paimon_tpu_torch.catalog.privilege",
                 "paimon_tpu_torch.catalog.auth",
                 "paimon_tpu_torch.catalog.jdbc",
                 "paimon_tpu_torch.catalog.rest",
                 "paimon_tpu_torch.sql",
                 "paimon_tpu_torch.sql.parser",
                 "paimon_tpu_torch.sql.executor",
                 "paimon_tpu_torch.cli",
                 "paimon_tpu_torch.__main__",
                 "paimon_tpu_torch.cdc",
                 "paimon_tpu_torch.cdc.formats",
                 "paimon_tpu_torch.cdc.computed",
                 "paimon_tpu_torch.cdc.source",
                 "paimon_tpu_torch.cdc.sink",
                 "paimon_tpu_torch.cdc.database_sync",
                 "paimon_tpu_torch.service.stream_daemon",
                 "paimon_tpu_torch.obs.merge",
                 "paimon_tpu_torch.vector",
                 "paimon_tpu_torch.vector.ann",
                 "paimon_tpu_torch.vector.hybrid",
                 "paimon_tpu_torch.index.fulltext",
                 "paimon_tpu_torch.iceberg",
                 "paimon_tpu_torch.iceberg.metadata",
                 "paimon_tpu_torch.iceberg.reader",
                 "paimon_tpu_torch.iceberg.rest",
                 "paimon_tpu_torch.integrations",
                 "paimon_tpu_torch.integrations.torch_data",
                 "paimon_tpu_torch.integrations.jax_data",
                 "paimon_tpu_torch.integrations.ray_data",
                 "paimon_tpu_torch.integrations.daft_data",
                 "paimon_tpu_torch.table.topology",
                 "paimon_tpu_torch.vfs"):
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


def test_entry_points_raise_without_cuda(tmp_path, capsys):
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
    _cdc_and_stream_raise_without_cuda(tmp_path, capsys)
    _search_raises_without_cuda(tmp_path)


def _search_raises_without_cuda(tmp_path):
    """The vector indexes that train or search on a device, the persisted
    index's build and the table searches take device=None as cuda (the
    searches take their table's), so without a card and without
    device="cpu" they raise naming CUDA; HNSW is host code and takes no
    device."""
    import numpy as np
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import ArrayType, BigIntType, FloatType
    from paimon_tpu_torch.vector import hybrid_search, vector_search
    from paimon_tpu_torch.vector.ann import (BruteForceIndex, HNSWIndex,
                                             IVFFlatIndex, IVFPQIndex,
                                             IVFSQIndex,
                                             PersistedVectorIndex)

    v = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    for make in (lambda: BruteForceIndex(v, "l2"),
                 lambda: IVFFlatIndex(v, n_clusters=4),
                 lambda: IVFPQIndex(v, m=2),
                 lambda: IVFSQIndex(v)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert len(HNSWIndex(v, m=4)) == 64
    path = str(tmp_path / "vecs")
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("emb", ArrayType(FloatType()))
              .options({"bucket": "-1"}).build())
    t = FileStoreTable.create(path, schema, device="cpu")
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(pa.table({"id": pa.array(range(64), pa.int64()),
                            "emb": pa.array(v.tolist(),
                                            pa.list_(pa.float32()))}))
    wb.new_commit().commit(w.prepare_commit())
    w.close()
    route = [{"type": "vector", "column": "emb", "query": v[0].tolist()}]
    for run in (lambda: PersistedVectorIndex(FileStoreTable.load(path),
                                             "emb").build(m=2),
                lambda: vector_search(FileStoreTable.load(path), "emb",
                                      v[0]),
                lambda: hybrid_search(FileStoreTable.load(path), route)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    # a table asked onto the CPU searches and builds there
    cpu = FileStoreTable.load(path, device="cpu")
    assert vector_search(cpu, "emb", v[0], k=3).num_rows == 3
    assert hybrid_search(cpu, route, k=2).num_rows == 2
    assert len(PersistedVectorIndex(cpu, "emb").build(m=2)) == 64


def _cdc_and_stream_raise_without_cuda(tmp_path, capsys):
    """The CDC sink, the database sync, the stream daemon and `table
    stream` reach their tables through the port's entry points, so
    without a card and without device="cpu" (--device cpu) they raise
    naming CUDA instead of running on the CPU."""
    import json

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.catalog import create_catalog
    from paimon_tpu_torch.cdc import CdcDatabaseSync, CdcSinkWriter
    from paimon_tpu_torch.cdc.source import FileCdcSource
    from paimon_tpu_torch.cli import main
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", BigIntType()).primary_key("id")
              .options({"bucket": "1"}).build())
    path = str(tmp_path / "s")
    FileStoreTable.create(path, schema, device="cpu")
    events = str(tmp_path / "events.jsonl")
    with open(events, "w") as f:
        f.write(json.dumps({"op": "c", "after": {"id": 1, "v": 1}}) + "\n")
    source = FileCdcSource(events)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamDaemon(FileStoreTable.load(path), source)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CdcSinkWriter(FileStoreTable.load(path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CdcDatabaseSync(create_catalog({"warehouse": str(tmp_path / "w")}),
                        "appdb")
    # the CPU asked for runs
    table = FileStoreTable.load(path, device="cpu")
    assert StreamDaemon(table, source).device.type == "cpu"
    sink = CdcSinkWriter(table)
    sink.write_events([{"op": "c", "after": {"id": 2, "v": 2}}])
    assert sink.commit(1) is not None
    sink.close()
    wh = str(tmp_path / "wh")
    assert main(["--device", "cpu", "-w", wh, "db", "create", "d1"]) == 0
    assert main(["--device", "cpu", "-w", wh, "table", "create", "d1.t",
                 "--column", "id:BIGINT NOT NULL", "--column", "v:BIGINT",
                 "--primary-key", "id"]) == 0
    capsys.readouterr()
    assert main(["-w", wh, "table", "stream", "d1.t", "--source", events,
                 "--duration", "0.1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def _keys_read_by(module_file):
    """The keys of every CoreOptions constant a reference module names."""
    import re

    from paimon_tpu.options import CoreOptions as RefCoreOptions
    with open(module_file) as f:
        names = set(re.findall(r"(?:CoreOptions|_CO)\.([A-Z][A-Z0-9_]+)",
                               f.read()))
    return {getattr(RefCoreOptions, n).key for n in names
            if hasattr(getattr(RefCoreOptions, n), "key")}


@pytest.mark.parametrize("module", [
    "core/dynamic_bucket.py", "core/cross_partition.py",
    "compact/compact_action.py", "schema/schema_manager.py",
    "data/casting.py"])
def test_every_bucket_mode_and_schema_option_key_is_defined_or_refused(
        tmp_path, module):
    """Each CoreOptions key that the reference's bucket-mode, compaction,
    schema and casting modules read is defined by the port (spelled as
    the reference spells it), or a table that sets it refuses writes
    with NotImplementedError naming its ROADMAP.md item."""
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.options import CoreOptions
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    port_keys = {v.key for v in vars(CoreOptions).values()
                 if hasattr(v, "key")}
    for key in sorted(_keys_read_by(
            os.path.join(REPO, "paimon_tpu", module)) - port_keys):
        schema = (Schema.builder().column("id", BigIntType(False))
                  .primary_key("id").options({"bucket": "1", key: "1"})
                  .build())
        table = FileStoreTable.create(str(tmp_path / key), schema,
                                      device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            table.new_batch_write_builder().new_write()


# Keys the reference reads that the port neither defines nor refuses:
# each is read only by a reference module that is not ported.  Each
# names the ROADMAP.md item that ports it.
_NOT_YET_READ: dict = {}


def _keys_read_by_reference():
    """{key: modules} for every CoreOptions constant a module of
    paimon_tpu/ names (options.py's own property bodies aside: a key
    counts where a module reads it)."""
    keys = {}
    root = os.path.join(REPO, "paimon_tpu")
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or \
                    os.path.join(d, f) == os.path.join(root, "options.py"):
                continue
            for key in _keys_read_by(os.path.join(d, f)):
                keys.setdefault(key, set()).add(
                    os.path.relpath(os.path.join(d, f), root))
    return keys


def test_every_option_key_the_reference_reads_is_defined_or_refused(
        tmp_path):
    """Each CoreOptions key any module of paimon_tpu/ reads is defined
    by the port, or a table that sets it raises NotImplementedError
    naming its ROADMAP.md item (at create or at write), or it is listed
    in _NOT_YET_READ with the ROADMAP.md item that ports its reader.  A
    key the port accepts and ignores fails here."""
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.options import CoreOptions
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    port_keys = {v.key for v in vars(CoreOptions).values()
                 if hasattr(v, "key")}
    reads = _keys_read_by_reference()
    ignored = []
    for key in sorted(set(reads) - port_keys):
        if key in _NOT_YET_READ:
            assert _NOT_YET_READ[key] in roadmap, key
            continue
        schema = (Schema.builder().column("id", BigIntType(False))
                  .primary_key("id").options({"bucket": "1", key: "1"})
                  .build())
        try:
            table = FileStoreTable.create(str(tmp_path / key), schema,
                                          device="cpu")
            table.new_batch_write_builder().new_write().close()
        except NotImplementedError as e:
            assert "ROADMAP.md" in str(e), key
            continue
        ignored.append((key, sorted(reads[key])))
    assert ignored == []
    # no stale entry: each listed key is read by the reference and not
    # yet defined by the port
    assert sorted(k for k in _NOT_YET_READ
                  if k in port_keys or k not in reads) == []


# the keys _NOT_YET_READ listed until the read and write planes
# (ROADMAP.md A.8.5) were ported: spilling, staging, the prefetch byte
# budget and the plan cache
_A85_KEYS = ["local-sort.max-num-file-handles", "sort-spill-buffer-size",
             "spill-compression", "spill-compression.zstd-level",
             "write-buffer-spill.max-disk-size", "write.stage.parallelism",
             "read.prefetch.max-bytes", "scan.plan.cache",
             "scan.plan.cache.max-entries"]


def _assert_ported_key_matches_reference(key):
    """`key` is defined with the reference's spelling, parser and
    default, and a module of the port reads it."""
    from paimon_tpu.options import CoreOptions as RefCoreOptions
    from paimon_tpu_torch.options import CoreOptions

    def by_key(cls):
        return {v.key: (n, v) for n, v in vars(cls).items()
                if hasattr(v, "key")}

    name, opt = by_key(CoreOptions)[key]
    ref_name, ref = by_key(RefCoreOptions)[key]
    assert name == ref_name
    assert opt.default == ref.default
    assert opt.typ.__name__ == ref.typ.__name__
    pkg = os.path.join(REPO, "paimon_tpu_torch")
    readers = []
    for d, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py") and f != "options.py":
                with open(path) as fh:
                    if f"CoreOptions.{name}" in fh.read():
                        readers.append(f)
    assert readers, key


@pytest.mark.parametrize("key", _A85_KEYS)
def test_ported_read_write_plane_keys_match_reference(key):
    """Each key the port now reads is defined with the reference's
    spelling, parser and default, and a module of the port reads it."""
    _assert_ported_key_matches_reference(key)


# the keys _NOT_YET_READ listed until append tables were ported: the
# append compaction's picker, the deletion-vector read mask and the
# append split binning
_A87_KEYS = ["compaction.delete-ratio-threshold",
             "compaction.small-file-ratio", "compaction.min.file-num",
             "deletion-vectors.merge-on-read",
             "source.split.open-file-cost", "source.split.target-size"]


@pytest.mark.parametrize("key", _A87_KEYS)
def test_ported_append_keys_match_reference(key):
    """Each append-table key the port now reads is defined with the
    reference's spelling, parser and default, and a module of the port
    reads it."""
    _assert_ported_key_matches_reference(key)


# the keys _NOT_YET_READ listed until the stream daemon was ported
_STREAM_KEYS = ["stream.checkpoint.interval", "stream.compaction.full",
                "stream.compaction.interval",
                "stream.compaction.pause-backlog",
                "stream.compaction.pause-ratio", "stream.expire.interval",
                "stream.ingest.max-batch", "stream.ingest.poll-interval",
                "stream.manifest-compaction.interval",
                "stream.restart.backoff", "stream.restart.backoff.cap",
                "stream.restart.healthy-threshold",
                "stream.restart.max-restarts", "stream.serve.buffer.rows",
                "stream.serve.poll-interval"]


@pytest.mark.parametrize("key", _STREAM_KEYS)
def test_ported_stream_keys_match_reference(key):
    """Each stream daemon key is defined with the reference's spelling,
    parser and default, and a module of the port reads it."""
    _assert_ported_key_matches_reference(key)


# the keys _NOT_YET_READ listed until the multi-host planes were ported
# (parallel/distributed.py and parallel/maintenance_plane.py)
_MULTIHOST_KEYS = ["multihost.commit.arbitration",
                   "multihost.scan.pin-snapshot", "multihost.write.routing",
                   "multihost.lease.interval", "multihost.lease.timeout",
                   "multihost.maintenance.lease-walk",
                   "multihost.maintenance.takeover",
                   "multihost.rejoin.enabled"]


@pytest.mark.parametrize("key", _MULTIHOST_KEYS)
def test_ported_multihost_keys_match_reference(key):
    """Each multi-host planes' key is defined with the reference's
    spelling, parser and default, and a module of the port reads it."""
    _assert_ported_key_matches_reference(key)
