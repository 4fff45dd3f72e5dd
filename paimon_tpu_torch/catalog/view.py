"""Catalog views: named queries stored in the catalog.

reference: paimon-api view/{View, ViewImpl, ViewSchema}.java +
Catalog.createView/getView/listViews/dropView (Catalog.java:502).  A
view is a SQL query text with an optional comment and options;
engines expand it at query time.  FileSystemCatalog persists each view
as `<db>.db/<name>.view/view.json` (the `.view` suffix keeps the
namespace disjoint from table directories, which carry `schema/`).
"""

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["View"]


@dataclass
class View:
    query: str
    comment: Optional[str] = None
    options: Dict[str, str] = field(default_factory=dict)
    dialects: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "query": self.query,
            "comment": self.comment,
            "options": self.options,
            "dialects": self.dialects,
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "View":
        d = json.loads(text)
        return View(query=d["query"], comment=d.get("comment"),
                    options=d.get("options") or {},
                    dialects=d.get("dialects") or {})
