"""Command-line interface: `python -m paimon_tpu_torch ...`.

The reference ships a `paimon` CLI over the Python catalog
(pypaimon/cli/cli.py: table/db/catalog/sql/branch/tag subcommands with
a yaml catalog config).  This is the same surface as paimon_tpu's
(paimon_tpu/cli.py), over paimon_tpu_torch:

  paimon --warehouse /wh db list|create|drop
  paimon --warehouse /wh table list|get|read|snapshot|create|drop|
                           compact|import|rename|set-option|add-column
  paimon --warehouse /wh tag list|create|delete <db.table> [...]
  paimon --warehouse /wh branch list|create|delete|fast-forward ...
  paimon --warehouse /wh sql "SELECT ..." | sql   (interactive REPL)
  paimon lint [--json] [--rule ID] [--list-rules]

Catalog selection: --warehouse PATH (filesystem), or --config FILE — a
JSON file of catalog options ({"warehouse": ..., "metastore": ...}),
or the PAIMON_WAREHOUSE environment variable.

--device picks the device the catalog's tables run on: the card
("cuda") unless given, which raises without one; `--device cpu` runs
on the CPU.  `table stream` runs the streaming daemon over a JSONL file
of CDC events until SIGTERM or --duration, `fleet status` reads the
multi-host planes' ownership generations, leases and ledgers from a
table's snapshots, and `fleet trace --merge DIR` merges the trace
spools under DIR.  `lint [--json] [--rule ID]` runs the whole-program
analysis plane (analysis/) over the installed package, or over
`--package-dir`; it opens no catalog and no device, so it takes no
`--device`.
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import pyarrow as pa


def _load_catalog(args):
    from paimon_tpu_torch.catalog.catalog import create_catalog
    opts = {}
    if getattr(args, "config", None):
        with open(args.config) as f:
            opts.update(json.load(f))
    if getattr(args, "warehouse", None):
        opts["warehouse"] = args.warehouse
    if not opts.get("warehouse") and os.environ.get("PAIMON_WAREHOUSE"):
        opts["warehouse"] = os.environ["PAIMON_WAREHOUSE"]
    if not opts:
        raise SystemExit("no catalog configured: pass --warehouse, "
                         "--config, or set PAIMON_WAREHOUSE")
    return create_catalog(opts, device=getattr(args, "device", None))


def _print_table(t: pa.Table, fmt: str, out=None):
    out = out or sys.stdout
    if fmt == "json":
        for row in t.to_pylist():
            out.write(json.dumps(row, default=str) + "\n")
        return
    if fmt == "csv":
        import pyarrow.csv as pacsv
        buf = pa.BufferOutputStream()
        pacsv.write_csv(t, buf)
        out.write(buf.getvalue().to_pybytes().decode())
        return
    # plain aligned text table
    cols = t.column_names
    rows = [[("" if v is None else str(v)) for v in row.values()]
            for row in t.to_pylist()]
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out.write(line + "\n")
    out.write("|" + "|".join(f" {c.ljust(w)} "
                             for c, w in zip(cols, widths)) + "|\n")
    out.write(line + "\n")
    for r in rows:
        out.write("|" + "|".join(f" {v.ljust(w)} "
                                 for v, w in zip(r, widths)) + "|\n")
    out.write(line + "\n")
    out.write(f"{t.num_rows} row(s)\n")


def _table(catalog, name: str):
    from paimon_tpu_torch.catalog.catalog import Identifier
    if "." not in name:
        raise SystemExit(f"table must be db.table, got {name!r}")
    return catalog.get_table(Identifier.parse(name))


# -- subcommand handlers ----------------------------------------------------

def cmd_db(args):
    catalog = _load_catalog(args)
    if args.db_cmd == "list":
        for d in sorted(catalog.list_databases()):
            print(d)
    elif args.db_cmd == "create":
        catalog.create_database(args.name, ignore_if_exists=args.if_not_exists)
        print("OK")
    elif args.db_cmd == "drop":
        catalog.drop_database(args.name, ignore_if_not_exists=True,
                              cascade=getattr(args, "cascade", False))
        print("OK")


class _TraceScope:
    """`--trace out.json`: enable span tracing for the command and
    export the ring as Chrome trace-event JSON (Perfetto) on the way
    out — the CLI's one-shot equivalent of trace.export.path."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def __enter__(self):
        if self.path:
            from paimon_tpu_torch.obs.trace import enable_tracing
            enable_tracing()
        return self

    def __exit__(self, *exc):
        if self.path:
            from paimon_tpu_torch.obs.trace import (
                disable_tracing, export_chrome_trace,
            )
            export_chrome_trace(self.path)
            disable_tracing()
            print(f"trace written to {self.path}", file=sys.stderr)
        return False


def cmd_table(args):
    catalog = _load_catalog(args)
    cmd = args.table_cmd
    if cmd == "list":
        for t in sorted(catalog.list_tables(args.database)):
            print(t)
        return
    table = None
    if cmd == "get":
        table = _table(catalog, args.table)
        schema = table.schema
        info = {
            "name": args.table,
            "fields": [{"name": f.name, "type": str(f.type),
                        "comment": getattr(f, "description", None)}
                       for f in schema.fields],
            "primary_keys": schema.primary_keys,
            "partition_keys": schema.partition_keys,
            "options": schema.options,
        }
        print(json.dumps(info, indent=2, default=str))
    elif cmd == "read":
        table = _table(catalog, args.table)
        from paimon_tpu_torch import predicate as P  # noqa: F401
        projection = args.columns.split(",") if args.columns else None
        with _TraceScope(getattr(args, "trace", None)):
            out = table.to_arrow(projection=projection)
        if args.limit:
            out = out.slice(0, args.limit)
        _print_table(out, args.format)
    elif cmd == "snapshot":
        table = _table(catalog, args.table)
        snap = table.latest_snapshot()
        if snap is None:
            print("no snapshots")
        else:
            print(snap.to_json())
    elif cmd == "snapshots":
        table = _table(catalog, args.table)
        _print_table(table.system_table("snapshots"), args.format)
    elif cmd == "create":
        from paimon_tpu_torch.catalog.catalog import Identifier
        from paimon_tpu_torch.schema import Schema
        from paimon_tpu_torch.types import parse_data_type
        b = Schema.builder()
        for coldef in args.column:
            name, _, typ = coldef.partition(":")
            b.column(name, parse_data_type(typ or "STRING"))
        if args.primary_key:
            b.primary_key(*args.primary_key.split(","))
        if args.partition_by:
            b.partition_keys(*args.partition_by.split(","))
        for opt in args.option or []:
            k, _, v = opt.partition("=")
            b.option(k, v)
        catalog.create_table(Identifier.parse(args.table), b.build(),
                             ignore_if_exists=args.if_not_exists)
        print("OK")
    elif cmd == "drop":
        from paimon_tpu_torch.catalog.catalog import Identifier
        catalog.drop_table(Identifier.parse(args.table),
                           ignore_if_not_exists=True)
        print("OK")
    elif cmd == "rename":
        from paimon_tpu_torch.catalog.catalog import Identifier
        catalog.rename_table(Identifier.parse(args.table),
                             Identifier.parse(args.to))
        print("OK")
    elif cmd == "compact":
        table = _table(catalog, args.table)
        with _TraceScope(getattr(args, "trace", None)):
            sid = table.compact(full=args.full)
        print(f"snapshot {sid}" if sid else "nothing to do")
    elif cmd == "compact-manifests":
        table = _table(catalog, args.table)
        sid = table.compact_manifests(force=not args.if_needed)
        print(f"snapshot {sid}" if sid else "nothing to do")
    elif cmd == "import":
        table = _table(catalog, args.table)
        path = args.file
        if path.endswith(".csv"):
            import pyarrow.csv as pacsv
            data = pacsv.read_csv(path)
        elif path.endswith(".json") or path.endswith(".jsonl"):
            import pyarrow.json as pajson
            data = pajson.read_json(path)
        elif path.endswith(".parquet"):
            import pyarrow.parquet as pq
            data = pq.read_table(path)
        else:
            raise SystemExit(f"unsupported import format: {path}")
        schema = table.arrow_schema()
        data = data.select([c for c in data.column_names
                            if c in schema.names]).cast(
            pa.schema([schema.field(c) for c in data.column_names
                       if c in schema.names]))
        wb = table.new_batch_write_builder()
        with _TraceScope(getattr(args, "trace", None)), \
                wb.new_write() as w:
            w.write_arrow(data)
            wb.new_commit().commit(w.prepare_commit())
        print(f"{data.num_rows} rows imported")
    elif cmd == "set-option":
        from paimon_tpu_torch.catalog.catalog import Identifier
        from paimon_tpu_torch.schema.schema_manager import SchemaChange
        catalog.alter_table(Identifier.parse(args.table),
                            [SchemaChange.set_option(args.key, args.value)])
        print("OK")
    elif cmd == "remove-option":
        from paimon_tpu_torch.catalog.catalog import Identifier
        from paimon_tpu_torch.schema.schema_manager import SchemaChange
        catalog.alter_table(Identifier.parse(args.table),
                            [SchemaChange.remove_option(args.key)])
        print("OK")
    elif cmd == "add-column":
        from paimon_tpu_torch.catalog.catalog import Identifier
        from paimon_tpu_torch.schema.schema_manager import SchemaChange
        from paimon_tpu_torch.types import parse_data_type
        catalog.alter_table(
            Identifier.parse(args.table),
            [SchemaChange.add_column(args.name,
                                     parse_data_type(args.type))])
        print("OK")
    elif cmd == "expire-snapshots":
        table = _table(catalog, args.table)
        n = table.expire_snapshots(retain_max=args.retain_max)
        print(f"{n or 0} snapshots expired")
    elif cmd == "metrics":
        table = _table(catalog, args.table)
        out = table.system_table("metrics")
        if args.group:
            import pyarrow.compute as pc
            out = out.filter(pc.equal(out.column("group"), args.group))
        _print_table(out, args.format)
    elif cmd == "stream":
        table = _table(catalog, args.table)
        from paimon_tpu_torch.cdc.source import FileCdcSource
        from paimon_tpu_torch.service.stream_daemon import StreamDaemon
        dynamic = {}
        for opt in args.option or []:
            k, _, v = opt.partition("=")
            dynamic[k] = v
        source = FileCdcSource(args.source)
        daemon = StreamDaemon(
            table, source, format=args.cdc_format,
            commit_user=args.commit_user,
            compact=not args.no_compact, serve=not args.no_serve,
            dynamic_options=dynamic or None)
        server = None
        with _TraceScope(getattr(args, "trace", None)):
            daemon.install_signal_handlers()
            daemon.start()
            if not args.no_serve:
                # the CLI has no in-process consumer: drain the bounded
                # changelog buffer (keeping the serve loop and its
                # freshness measurement live); remote consumers use
                # /changelog, which runs its own per-consumer scans
                from paimon_tpu_torch.parallel.executors import (
                    spawn_thread,
                )

                def _drain_buffer():
                    while daemon.poll_changelog(timeout=1.0) or \
                            daemon._serve_alive():
                        pass

                spawn_thread(_drain_buffer,
                             name="paimon-stream-cli-drain")
            if args.serve_port is not None:
                from paimon_tpu_torch.service.query_service import (
                    KvQueryServer,
                )
                server = KvQueryServer(table,
                                       port=args.serve_port).start()
                print(f"query service (with /changelog) at "
                      f"{server.address}", file=sys.stderr)
            try:
                status = daemon.run_forever(args.duration)
            finally:
                if server is not None:
                    server.stop()
        print(json.dumps(status, indent=2, default=str))
        if any(lp["failed"] for lp in status["loops"].values()):
            raise SystemExit(1)
    elif cmd == "debug-bundle":
        table = _table(catalog, args.table)
        out_path = args.out or "debug-bundle.json"
        bundle = build_debug_bundle(table, serving=args.serving,
                                    base_user=args.base_user,
                                    lease_walk=args.lease_walk)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=2, default=str)
        os.replace(tmp, out_path)
        print(json.dumps({
            "out": out_path,
            "flight_events": len(bundle["flight"]["events"]),
            "metric_rows": len(bundle["metrics"]),
            "distributed": bundle["fleet"].get("distributed", False),
            "serving": bundle["healthz"] is not None,
        }, indent=2))
    elif cmd == "fsck":
        table = _table(catalog, args.table)
        report = table.fsck(snapshot_id=args.snapshot, deep=args.deep,
                            incremental=args.incremental,
                            stamp_watermark=args.stamp_watermark)
        if args.fix and not report.ok:
            from paimon_tpu_torch.maintenance import fix_violations
            actions = fix_violations(table, report)
            report = table.fsck(snapshot_id=args.snapshot,
                                deep=args.deep,
                                incremental=args.incremental,
                                stamp_watermark=args.stamp_watermark)
            out = report.to_dict()
            out["fix_actions"] = actions
        else:
            out = report.to_dict()
        print(json.dumps(out, indent=2, default=str))
        if not report.ok:
            raise SystemExit(1)


def cmd_tag(args):
    catalog = _load_catalog(args)
    table = _table(catalog, args.table)
    if args.tag_cmd == "list":
        _print_table(table.system_table("tags"), args.format)
    elif args.tag_cmd == "create":
        table.create_tag(args.name, args.snapshot)
        print("OK")
    elif args.tag_cmd == "delete":
        table.delete_tag(args.name)
        print("OK")


def cmd_branch(args):
    catalog = _load_catalog(args)
    table = _table(catalog, args.table)
    if args.branch_cmd == "list":
        _print_table(table.system_table("branches"), args.format)
    elif args.branch_cmd == "create":
        table.create_branch(args.name, args.tag)
        print("OK")
    elif args.branch_cmd == "delete":
        table.delete_branch(args.name)
        print("OK")
    elif args.branch_cmd == "fast-forward":
        table.fast_forward(args.name)
        print("OK")


def _fleet_view(table, base_user: str, lease_walk: int) -> Dict:
    """Fleet-plane introspection, read purely from snapshot
    properties through parallel/distributed.py's stamp readers (no raw
    `multihost.ownership.*` parsing here)."""
    import time as _time

    from paimon_tpu_torch.parallel.distributed import (
        merge_lease_view, merge_rejoin_requests,
        resume_generation_history,
    )
    from paimon_tpu_torch.service.stream_daemon import recover_plane_stamps

    hist = resume_generation_history(table)
    if hist is None:
        return {"distributed": False}
    current = hist.current()
    now = int(_time.time() * 1000)
    leases = merge_lease_view(table, max_walk=lease_walk)
    requests = merge_rejoin_requests(table)
    hosts = {}
    for p in range(current.num_processes):
        ledger, floors = recover_plane_stamps(
            table, f"{base_user}-p{p}")
        # bucket shares for the default partition — partitioned
        # tables shard per (partition, bucket), so per-partition
        # ownership can differ; this is the representative view
        owned = [b for b in range(current.num_buckets)
                 if current.owner_of((), b) == p]
        lease_ms = leases.get(p)
        hosts[str(p)] = {
            "dead": p in current.dead,
            "rejoin_requested": p in requests,
            "lease_age_ms": None if lease_ms is None
            else max(0, now - lease_ms),
            "adopted": sorted(ledger),
            "floors": {str(k): v for k, v in sorted(floors.items())},
            "owned_buckets": owned,
        }
    out = {
        "distributed": True,
        "version": current.version,
        "processes": current.num_processes,
        "buckets": current.num_buckets,
        "dead": sorted(current.dead),
        "rejoining": sorted(p for p in requests if p in current.dead),
        "hosts": hosts,
        "generations": [
            {"version": m.version, "processes": m.num_processes,
             "buckets": m.num_buckets, "dead": sorted(m.dead)}
            for m in hist.entries],
    }
    return out


def _options_diff(table) -> Dict:
    """Explicitly-set table options vs their registered defaults —
    the 'what is different about THIS table' half of a debug bundle."""
    from paimon_tpu_torch.options import ConfigOption, CoreOptions

    defaults = {v.key: v.default for v in vars(CoreOptions).values()
                if isinstance(v, ConfigOption)}
    diff = {}
    for k, v in sorted(table.options.to_map().items()):
        d = defaults.get(k)
        if d is not None and str(d) == v:
            continue                       # explicitly set to default
        diff[k] = {"value": v,
                   "default": None if d is None else str(d),
                   "known": k in defaults}
    return diff


def build_debug_bundle(table, serving: Optional[str] = None,
                       base_user: str = "stream-daemon",
                       lease_walk: int = 16) -> Dict:
    """One support artifact with everything a post-mortem starts
    from: the black-box flight ring, a full metrics snapshot, the
    serving plane's /healthz + /slo (best-effort — the server may be
    the thing that died), the store-derived fleet view, and the
    table's options diff vs defaults."""
    import time as _time

    from paimon_tpu_torch.metrics import global_registry
    from paimon_tpu_torch.obs import flight
    from paimon_tpu_torch.obs.trace import process_tag

    bundle: Dict = {
        "created_ms": int(_time.time() * 1000),
        "table": table.name,
        "process": process_tag(),
        "flight": {"events": flight.recorder().snapshot()},
        "metrics": global_registry().snapshot_rows(),
        "healthz": None,
        "slo": None,
        "fleet": {},
        "options": _options_diff(table),
    }
    try:
        from paimon_tpu_torch.service.query_service import KvQueryClient
        client = KvQueryClient(
            table=None if serving else table, address=serving,
            follow_topology=False)
        bundle["healthz"] = client.healthz()
        bundle["slo"] = client.slo()
    except Exception as e:                 # noqa: BLE001 — diagnostic
        bundle["serving_error"] = f"{type(e).__name__}: {e}"
    try:
        bundle["fleet"] = _fleet_view(table, base_user, lease_walk)
    except Exception as e:                 # noqa: BLE001 — diagnostic
        bundle["fleet"] = {"error": f"{type(e).__name__}: {e}"}
    return bundle


def cmd_fleet(args):
    if args.fleet_cmd == "trace":
        from paimon_tpu_torch.obs.merge import export_merged
        stats = export_merged(args.merge, args.out)
        print(json.dumps(stats, indent=2))
        if stats["processes"] == 0:
            raise SystemExit(1)
        return
    catalog = _load_catalog(args)
    table = _table(catalog, args.table)
    out = _fleet_view(table, args.base_user, args.lease_walk)
    if getattr(args, "serving", None):
        # the store plane above is read from snapshots; the serving
        # plane (SLO burn rates) lives behind HTTP — best-effort so a
        # downed router never hides the store-side view
        try:
            from paimon_tpu_torch.service.query_service import KvQueryClient
            out["slo"] = KvQueryClient(address=args.serving,
                                       follow_topology=False).slo()
        except Exception as e:             # noqa: BLE001 — diagnostic
            out["slo"] = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(out, indent=2))


def cmd_sql(args):
    from paimon_tpu_torch.sql import SQLContext
    catalog = _load_catalog(args)
    ctx = SQLContext(catalog, database=args.database)
    if args.query:
        out = ctx.sql(args.query)
        _print_table(out, args.format)
        return
    # interactive REPL (reference cli_sql.py _interactive_repl)
    print("paimon sql — ';' terminates a statement, exit/quit leaves")
    buf: List[str] = []
    while True:
        try:
            prompt = "paimon> " if not buf else "   ...> "
            line = input(prompt)
        except EOFError:
            break
        if not buf and line.strip().lower() in ("exit", "quit", "\\q"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            query = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            if not query.strip():
                continue
            try:
                _print_table(ctx.sql(query), args.format)
            except Exception as e:                 # noqa: BLE001
                print(f"error: {e}", file=sys.stderr)


def cmd_lint(args):
    """Whole-program static analysis: the same engine pass the tests
    run (paimon_tpu_torch/analysis/), for humans and external CI.  It
    parses source only: no catalog, no device.  Exit 1 when any
    unsuppressed finding exists."""
    from paimon_tpu_torch.analysis import META_RULES, all_rules, run_package

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:22s} {r.title}")
        return
    if args.rules:
        known = {r.id for r in all_rules()} | set(META_RULES)
        unknown = sorted(set(args.rules) - known)
        if unknown:
            raise SystemExit(
                f"unknown rule id(s): {', '.join(unknown)} "
                f"(see `paimon lint --list-rules`)")
    package_dir = args.package_dir or os.path.dirname(
        os.path.abspath(__file__))
    report = run_package(package_dir,
                         rule_ids=args.rules if args.rules else None)
    if args.json:
        print(report.to_json())
    else:
        for f in report.findings:
            if f.suppressed and not args.show_suppressed:
                continue
            tag = " [suppressed]" if f.suppressed else ""
            print(f"{f.file}:{f.line}: [{f.rule}]{tag} {f.message}")
        s = report.to_dict()["summary"]
        print(f"{len(report.model.modules)} files, "
              f"{len(report.rules)} rules: "
              f"{s['unsuppressed']} finding(s), "
              f"{s['suppressed']} suppressed")
    if report.unsuppressed:
        raise SystemExit(1)


# -- parser -----------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paimon",
        description="paimon_tpu_torch command line interface")
    p.add_argument("--warehouse", "-w", help="filesystem warehouse path")
    p.add_argument("--device", default=None,
                   help="device the tables run on: cuda (the default; "
                        "raises without a card) or cpu")
    p.add_argument("--config", "-c", help="JSON file of catalog options")
    p.add_argument("--format", "-f", default="table",
                   choices=["table", "csv", "json"], help="output format")
    sub = p.add_subparsers(dest="command")

    db = sub.add_parser("db", help="database operations")
    dbsub = db.add_subparsers(dest="db_cmd", required=True)
    dbsub.add_parser("list")
    c = dbsub.add_parser("create")
    c.add_argument("name")
    c.add_argument("--if-not-exists", action="store_true")
    c = dbsub.add_parser("drop")
    c.add_argument("name")
    c.add_argument("--cascade", action="store_true")
    db.set_defaults(func=cmd_db)

    t = sub.add_parser("table", help="table operations")
    tsub = t.add_subparsers(dest="table_cmd", required=True)
    c = tsub.add_parser("list")
    c.add_argument("database")
    c = tsub.add_parser("get")
    c.add_argument("table")
    c = tsub.add_parser("read")
    c.add_argument("table")
    c.add_argument("--columns", help="comma-separated projection")
    c.add_argument("--limit", type=int)
    c.add_argument("--trace", metavar="OUT.json",
                   help="trace the scan; write Chrome trace-event "
                        "JSON (opens in Perfetto)")
    c = tsub.add_parser("snapshot")
    c.add_argument("table")
    c = tsub.add_parser("snapshots")
    c.add_argument("table")
    c = tsub.add_parser("create")
    c.add_argument("table")
    c.add_argument("--column", action="append", default=[],
                   metavar="NAME:TYPE", help="repeatable column def")
    c.add_argument("--primary-key")
    c.add_argument("--partition-by")
    c.add_argument("--option", action="append", metavar="K=V")
    c.add_argument("--if-not-exists", action="store_true")
    c = tsub.add_parser("drop")
    c.add_argument("table")
    c = tsub.add_parser("rename")
    c.add_argument("table")
    c.add_argument("to")
    c = tsub.add_parser("compact")
    c.add_argument("table")
    c.add_argument("--full", action="store_true")
    c.add_argument("--trace", metavar="OUT.json",
                   help="trace the compaction; write Chrome "
                        "trace-event JSON (opens in Perfetto)")
    c = tsub.add_parser(
        "compact-manifests",
        help="fold accumulated delta manifests into sorted, "
             "partition-clustered base manifests")
    c.add_argument("table")
    c.add_argument("--if-needed", action="store_true",
                   help="run only when the manifest.full-compaction."
                        "threshold trigger fires")
    c = tsub.add_parser("import")
    c.add_argument("table")
    c.add_argument("file", help="csv/json/parquet file")
    c.add_argument("--trace", metavar="OUT.json",
                   help="trace the ingest; write Chrome trace-event "
                        "JSON (opens in Perfetto)")
    c = tsub.add_parser(
        "metrics", help="live process metric registry ($metrics)")
    c.add_argument("table")
    c.add_argument("--group",
                   help="filter to one metric group "
                        "(scan/write/compaction/commit/io/...)")
    c = tsub.add_parser("set-option")
    c.add_argument("table")
    c.add_argument("key")
    c.add_argument("value")
    c = tsub.add_parser("remove-option")
    c.add_argument("table")
    c.add_argument("key")
    c = tsub.add_parser("add-column")
    c.add_argument("table")
    c.add_argument("name")
    c.add_argument("type")
    c = tsub.add_parser("expire-snapshots")
    c.add_argument("table")
    c.add_argument("--retain-max", type=int)
    c = tsub.add_parser(
        "stream",
        help="run the streaming daemon: checkpointed exactly-once CDC "
             "ingest + triggered compaction + changelog serving")
    c.add_argument("table")
    c.add_argument("--source", required=True,
                   help="JSONL file of CDC envelopes (tailed; offset = "
                        "line number, checkpointed in snapshot "
                        "properties)")
    c.add_argument("--cdc-format", default="debezium",
                   help="debezium/canal/maxwell/ogg/dms/aliyun")
    c.add_argument("--commit-user", default="stream-daemon",
                   help="STABLE id keying exactly-once replay dedup "
                        "and offset recovery")
    c.add_argument("--duration", type=float,
                   help="seconds to run (default: until SIGTERM)")
    c.add_argument("--serve-port", type=int,
                   help="also start the query service (adds the "
                        "/changelog endpoint) on this port")
    c.add_argument("--no-compact", action="store_true",
                   help="disable the compaction loop")
    c.add_argument("--no-serve", action="store_true",
                   help="disable the changelog-serving loop")
    c.add_argument("--option", action="append", metavar="K=V",
                   help="dynamic table options (stream.*, write.*, ...)")
    c.add_argument("--trace", metavar="OUT.json",
                   help="trace the daemon; write Chrome trace-event "
                        "JSON (opens in Perfetto)")
    c = tsub.add_parser(
        "debug-bundle",
        help="write one support artifact: flight-recorder ring, "
             "metrics snapshot, /healthz + /slo (best-effort), fleet "
             "status, and the table's options diff vs defaults")
    c.add_argument("table")
    c.add_argument("--out", metavar="OUT.json",
                   help="bundle path (default: debug-bundle.json)")
    c.add_argument("--serving", metavar="HOST:PORT",
                   help="query service / router to probe for "
                        "/healthz + /slo (default: the table's "
                        "registered service address)")
    c.add_argument("--base-user", default="stream-daemon")
    c.add_argument("--lease-walk", type=int, default=16)
    c = tsub.add_parser(
        "fsck", help="verify the snapshot/manifest/file graph")
    c.add_argument("table")
    c.add_argument("--snapshot", type=int,
                   help="check one snapshot only")
    c.add_argument("--deep", action="store_true",
                   help="also read data files and verify stats")
    c.add_argument("--fix", action="store_true",
                   help="repair fixable violations "
                        "(maintenance/repair.py), then re-check")
    c.add_argument("--incremental", action="store_true",
                   help="verify only the delta since the last clean "
                        "sweep's watermark (silently runs full when "
                        "it is absent or invalidated)")
    c.add_argument("--stamp-watermark", action="store_true",
                   help="record a clean full-chain verification at "
                        "the tip, arming the next incremental run")
    t.set_defaults(func=cmd_table)

    tg = sub.add_parser("tag", help="tag operations")
    tgsub = tg.add_subparsers(dest="tag_cmd", required=True)
    c = tgsub.add_parser("list")
    c.add_argument("table")
    c = tgsub.add_parser("create")
    c.add_argument("table")
    c.add_argument("name")
    c.add_argument("--snapshot", type=int)
    c = tgsub.add_parser("delete")
    c.add_argument("table")
    c.add_argument("name")
    tg.set_defaults(func=cmd_tag)

    br = sub.add_parser("branch", help="branch operations")
    brsub = br.add_subparsers(dest="branch_cmd", required=True)
    c = brsub.add_parser("list")
    c.add_argument("table")
    c = brsub.add_parser("create")
    c.add_argument("table")
    c.add_argument("name")
    c.add_argument("--tag")
    c = brsub.add_parser("delete")
    c.add_argument("table")
    c.add_argument("name")
    c = brsub.add_parser("fast-forward")
    c.add_argument("table")
    c.add_argument("name")
    br.set_defaults(func=cmd_branch)

    fl = sub.add_parser("fleet", help="multi-host fleet plane")
    flsub = fl.add_subparsers(dest="fleet_cmd", required=True)
    c = flsub.add_parser(
        "status",
        help="ownership-generation history, lease view, dead/"
             "adopted/rejoining sets, per-host bucket shares")
    c.add_argument("table")
    c.add_argument("--base-user", default="stream-daemon",
                   help="the daemons' commit-user base (per-host "
                        "users are <base>-p<i>)")
    c.add_argument("--lease-walk", type=int, default=16,
                   help="newest-first snapshots merged into the "
                        "lease view")
    c.add_argument("--serving", metavar="HOST:PORT",
                   help="router (or single replica) to fold the "
                        "serving plane's /slo burn rates into the "
                        "status (best-effort)")
    c = flsub.add_parser(
        "trace",
        help="stitch per-process trace spools (trace.export.dir) "
             "into ONE Perfetto-loadable file: a track per process, "
             "flow arrows across every serving hop and store-carried "
             "link")
    c.add_argument("--merge", required=True, metavar="SPOOL_DIR",
                   help="the fleet's shared trace.export.dir")
    c.add_argument("--out", default="fleet-trace.json",
                   metavar="OUT.json",
                   help="merged Chrome trace-event JSON "
                        "(default: fleet-trace.json)")
    fl.set_defaults(func=cmd_fleet)

    s = sub.add_parser("sql", help="run SQL (or start a REPL)")
    s.add_argument("query", nargs="?", help="statement; omit for a REPL")
    s.add_argument("--database", "-d", default="default")
    s.set_defaults(func=cmd_sql)

    ln = sub.add_parser(
        "lint", help="whole-program static analysis (the tier-1 "
                     "rule engine); exit 1 on unsuppressed findings")
    ln.add_argument("--json", action="store_true",
                    help="machine-readable report (findings incl. "
                         "suppressed, summary counts)")
    ln.add_argument("--rule", action="append", dest="rules",
                    metavar="ID",
                    help="run only this rule id (repeatable; "
                         "see --list-rules)")
    ln.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ln.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in text output")
    ln.add_argument("--package-dir", metavar="DIR",
                    help="package root to analyse (default: the "
                         "installed paimon_tpu_torch)")
    ln.set_defaults(func=cmd_lint)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    try:
        args.func(args)
    except SystemExit as e:
        if isinstance(e.code, int):
            return e.code
        print(f"error: {e.code}", file=sys.stderr)
        return 1
    except Exception as e:                         # noqa: BLE001
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
