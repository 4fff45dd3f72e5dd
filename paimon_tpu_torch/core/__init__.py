"""Table-format core (L3): write, commit, scan, read operations.

reference: paimon-core/.../operation/ (AbstractFileStoreWrite,
FileStoreCommitImpl, FileStoreScan, MergeFileSplitRead, RawFileSplitRead).
"""
