"""Levels: the LSM shape of one bucket.

reference: mergetree/Levels.java:39, SortedRun.java, LevelSortedRun.java.
Level 0 holds one sorted run per file (overlapping); levels >= 1 are each
one key-sorted non-overlapping run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from paimon_tpu_torch.manifest import DataFileMeta

__all__ = ["SortedRun", "LevelSortedRun", "Levels"]


@dataclass
class SortedRun:
    files: List[DataFileMeta]

    @property
    def total_size(self) -> int:
        return sum(f.file_size for f in self.files)

    @property
    def row_count(self) -> int:
        return sum(f.row_count for f in self.files)

    @staticmethod
    def from_sorted(files: Sequence[DataFileMeta]) -> "SortedRun":
        return SortedRun(sorted(files, key=lambda f: f.min_key))


@dataclass
class LevelSortedRun:
    level: int
    run: SortedRun


class Levels:
    def __init__(self, files: Sequence[DataFileMeta], num_levels: int):
        self.num_levels = num_levels
        by_level: Dict[int, List[DataFileMeta]] = {}
        for f in files:
            by_level.setdefault(f.level, []).append(f)
        # newest first: L0 files by max seq desc, then levels 1..max
        self.level0 = sorted(by_level.get(0, []),
                             key=lambda f: -f.max_sequence_number)
        self.levels: Dict[int, SortedRun] = {
            lvl: SortedRun.from_sorted(fs)
            for lvl, fs in by_level.items() if lvl > 0}

    @property
    def max_level(self) -> int:
        return self.num_levels - 1

    def level_sorted_runs(self) -> List[LevelSortedRun]:
        """Runs ordered newest-first (reference Levels.levelSortedRuns)."""
        runs = [LevelSortedRun(0, SortedRun([f])) for f in self.level0]
        for lvl in sorted(self.levels):
            run = self.levels[lvl]
            if run.files:
                runs.append(LevelSortedRun(lvl, run))
        return runs

    def num_sorted_runs(self) -> int:
        return len(self.level_sorted_runs())

    def non_empty_highest_level(self) -> int:
        lvls = [lvl for lvl, r in self.levels.items() if r.files]
        if lvls:
            return max(lvls)
        return 0 if self.level0 else -1

    def all_files(self) -> List[DataFileMeta]:
        out = list(self.level0)
        for run in self.levels.values():
            out.extend(run.files)
        return out
