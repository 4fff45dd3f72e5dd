"""The host-SSD cache tier of paimon_tpu_torch against paimon_tpu.

The 16 cases of tests/test_tiered_storage.py run on both packages (see
tests/test_torch_object_store.py `run_case`): the disk tier's entries,
their validation and adoption across a restart, promotion after hits
and demotion under pressure, a wiped or corrupt tier that degrades to
the store and stays exact, eviction of compacted-away files from both
tiers, the hard byte bound under concurrent readers, staged uploads
that seed the read tier, and the latency-injecting store.  Entries
written by one package's tier are adopted by the other's, both ways,
byte for byte.
"""

import glob
import os

import pytest

from tests.test_torch_object_store import (  # noqa: F401 -- a fixture
    clean_process_state, expand, run_case,
)
from tests.test_torch_vector import case_ids

CASES = expand("test_tiered_storage")
# disk tiers of both packages point at per-test directories: they must
# not outlive the test
pytestmark = pytest.mark.usefixtures("clean_process_state")


def test_reference_cases_are_all_listed():
    assert len(CASES) == 16


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("case,params", CASES, ids=case_ids(CASES))
def test_reference_case(tmp_path, monkeypatch, request, case, params, pkg):
    run_case(case, params, pkg, tmp_path, monkeypatch, request)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_disk_tier_entries_adopted_across_packages(tmp_path, writer):
    from paimon_tpu.fs import caching as ref_caching
    from paimon_tpu_torch.fs import caching
    w_mod, r_mod = (ref_caching, caching) if writer == "reference" \
        else (caching, ref_caching)
    d = str(tmp_path / "c")
    tw = w_mod.DiskCacheTier(d, 1 << 20)
    entries = {tw.file_key("objfs://t/bucket-0/data-a.parquet"):
               bytes(range(256)) * 4,
               tw.range_key("objfs://t/manifest/manifest-b", 7, 300):
               b"R" * 300}
    for k, v in entries.items():
        assert tw.put(k, v)
    files = {os.path.basename(p): open(p, "rb").read()
             for p in glob.glob(os.path.join(d, "*.pce"))}
    tr = r_mod.DiskCacheTier(d, 1 << 20)
    assert len(tr) == len(entries) and tr.total_bytes == tw.total_bytes
    for k, v in entries.items():
        assert tr.get(k) == v
    # the same entry files: names from the same key digest, the same
    # header and payload
    tr2 = r_mod.DiskCacheTier(str(tmp_path / "c2"), 1 << 20)
    for k, v in entries.items():
        assert tr2.put(k, v)
    assert {os.path.basename(p): open(p, "rb").read()
            for p in glob.glob(os.path.join(str(tmp_path / "c2"),
                                            "*.pce"))} == files
