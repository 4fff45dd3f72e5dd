"""Storage I/O layer (L0).

Analog of the reference's ``FileIO`` SPI
(paimon-common/.../fs/FileIO.java) with scheme-based dispatch. The critical
contract is atomic publish: ``try_to_write_atomic`` must make a file visible
all-or-nothing and fail if the target exists -- this is what makes snapshot
commit a CAS (reference catalog/SnapshotCommit.java:27,
fs/RenamingTwoPhaseOutputStream.java).
"""

from paimon_tpu_torch.fs.fileio import (  # noqa: F401
    FileIO, FileStatus, LocalFileIO, get_file_io,
)
