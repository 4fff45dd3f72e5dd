"""Catalog functions (UDFs stored in the catalog).

reference: paimon-api function/{Function, FunctionImpl,
FunctionDefinition, FunctionChange}.java + Catalog.createFunction
(Catalog.java:1230) + pypaimon/function/.  A function has typed
input/return params and per-dialect definitions; this engine executes
the `sql` dialect (an expression over the parameter names) directly in
its SQL layer, while `file`/`lambda` definitions round-trip as
metadata for other engines.

FileSystemCatalog persists `<db>.db/<name>.function/function.json`.
"""

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["FunctionDefinition", "Function"]


@dataclass
class FunctionDefinition:
    """One dialect's implementation (reference FunctionDefinition:
    type `sql` (definition text), `lambda` (language + definition) or
    `file` (class name + file resources)."""
    type: str                                   # sql | lambda | file
    definition: Optional[str] = None
    language: Optional[str] = None
    class_name: Optional[str] = None
    file_resources: List[Dict[str, str]] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {"type": self.type}
        if self.definition is not None:
            d["definition"] = self.definition
        if self.language is not None:
            d["language"] = self.language
        if self.class_name is not None:
            d["className"] = self.class_name
        if self.file_resources:
            d["fileResources"] = self.file_resources
        return d

    @staticmethod
    def from_dict(d: dict) -> "FunctionDefinition":
        return FunctionDefinition(
            type=d["type"], definition=d.get("definition"),
            language=d.get("language"), class_name=d.get("className"),
            file_resources=d.get("fileResources") or [])


@dataclass
class Function:
    """input_params: [(name, type_str)]; return_type: type_str."""
    input_params: List[Tuple[str, str]]
    return_type: Optional[str] = None
    definitions: Dict[str, FunctionDefinition] = field(
        default_factory=dict)
    deterministic: bool = True
    comment: Optional[str] = None

    def definition(self, dialect: str) -> Optional[FunctionDefinition]:
        return self.definitions.get(dialect)

    def to_json(self) -> str:
        return json.dumps({
            "inputParams": [{"name": n, "type": t}
                            for n, t in self.input_params],
            "returnType": self.return_type,
            "definitions": {k: v.to_dict()
                            for k, v in self.definitions.items()},
            "deterministic": self.deterministic,
            "comment": self.comment,
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "Function":
        d = json.loads(text)
        return Function(
            input_params=[(p["name"], p["type"])
                          for p in d.get("inputParams") or []],
            return_type=d.get("returnType"),
            definitions={k: FunctionDefinition.from_dict(v)
                         for k, v in (d.get("definitions") or {}).items()},
            deterministic=d.get("deterministic", True),
            comment=d.get("comment"))
