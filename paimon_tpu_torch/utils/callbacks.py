"""User callback loading (reference CoreOptions commit.callbacks /
tag.callbacks + CommitCallback / TagCallback SPIs, loaded by
CallbackUtils): a comma-separated list of import paths, each
optionally constructed with a per-class parameter from the template
key 'commit.callback.#.param' (# = the class path as written).

A commit callback is any object with `call(table, snapshot_id,
messages)`; a tag callback any object with `call(table, tag_name,
snapshot_id)`. Exceptions propagate — a failing callback fails the
operation's caller, after the commit itself is durable (same ordering
as the reference: callbacks run post-CAS).

A copy of paimon_tpu/utils/callbacks.py (no JAX in it).
"""

from __future__ import annotations

import importlib
from typing import List

__all__ = ["load_callbacks"]


def load_callbacks(options, list_key: str, param_template: str
                   ) -> List[object]:
    # accept CoreOptions (unwrap) or a raw Options map
    if not hasattr(options, "get_or") and hasattr(options, "options"):
        options = options.options
    spec = options.get_or(list_key, None)
    if not spec:
        return []
    out = []
    for path in str(spec).split(","):
        path = path.strip()
        if not path:
            continue
        mod_name, _, cls_name = path.partition(":")
        if not cls_name:                      # also accept pkg.mod.Class
            mod_name, _, cls_name = path.rpartition(".")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        param = options.get_or(param_template.replace("#", path), None)
        out.append(cls(param) if param is not None else cls())
    return out
