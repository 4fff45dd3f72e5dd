#!/usr/bin/env python3
"""Drive paimon_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--rows N] [--c5-keys N] [--c5-commits N]
                          [--c5-rows-per-commit N]

Phases, each of which raises on failure (no result line is printed
then):

1. the card's name and power limit (nvidia-smi), printed again after the
   last phase;
2. build the CUDA kernels from paimon_tpu_torch/csrc with nvcc, and the
   host merge routes' C library from paimon_tpu_torch/native with the
   host compiler (the run fails if it does not load);
3. the port's device_sorted_winners on cuda against cpu (identical
   perm/winner/prev) for 2M random rows, and its segment reductions
   (sum, product, max, min of int32, int64, float32, float64) on cuda
   against cpu;
4. the main path, four tables, each with the kernels' launch counts
   set to 0 just before it and read just after; each is created,
   written as one commit per batch, read merge-on-read, fully
   compacted and read back, on the card:
   - dedup_bigint: bench.py's table (id BIGINT NOT NULL, v1 BIGINT, v2
     DOUBLE, v3 INT; bucket=1, write-only, deduplicate, parquet), 10
     commits of uniform ids in [0, rows/2) drawn from seed 7 (the
     streamed compaction), held row for row against a numpy
     last-writer-wins oracle;
   - device_decode_dedup: dedup_bigint's directory copied after its
     commits and loaded with read.device-decode=true: merge-on-read
     scan, streamed full compaction and read back, each held against
     the same oracle, every file through the device decode plane (no
     fallback), with the seconds of its four steps (DecodeTimer);
   - agg_sum_max_orc: BASELINE config 4 on the same batches
     (aggregation, v1 sum, v2 and v3 max; ORC runs at level 0 through
     file.format.per.level=0:orc, parquet after compaction), held row
     for row against numpy's per-id sum and max; its scan and
     compaction must launch the offset-value-code variant;
   - string_key_coverage: a small table keyed by strings, 1 in 64
     longer than the 16-byte key prefix, so full-order merges of
     truncated keys run the code variant too (a coverage check: its
     rates are not metrics);
   - partial_update_coverage: config 3's shape cut to 16K keys x 5
     commits of 64 columns (a sequence group of 8, a DOUBLE sum, an INT
     count, 1 row in 100 a DELETE), held against the same table run by
     the port on the CPU (exact; the float sum within rtol 1e-12), its
     float sum bit-identical across two scans on the card;
   - changelog_lookup_upsert: BASELINE config 5 (changelog-producer=
     lookup): a 10M-key bucket written and fully compacted, a consumer
     on latest-full with a consumer id, 20 streaming commits of 1M
     upserts (90% updates of live ids) with inline compaction, the
     consumer polling after each; every poll's changelog held against
     a numpy oracle of the state transitions, the folded stream against
     the batch read, a restored consumer finding nothing new; it
     reports sustained upsert rows/s, changelog latency, the stream
     read's rows/s and where the producer's time goes (ChangelogTimer);
   - changelog_producers_coverage: input, lookup and full-compaction at
     16K keys x 5 commits with deletes, each held file for file
     against the same table run by the port on the CPU;
   - device_decode_coverage: 256K rows of INT32, INT64, FLOAT, DOUBLE and
     DATE columns (dictionary pages, 1 value in 8 null, several row
     groups and pages a chunk) read on the card equal to pyarrow, a
     string-keyed table that falls back once and reads the same, and
     fused_decode_merge at 2^22 on the card equal to its CPU run;
   - mesh_compaction: parallel/dryrun.run_engines' tables (id BIGINT
     NOT NULL key, v DOUBLE, 8 buckets, write-only; deduplicate and
     aggregation with v sum; commits of 312.5K ids uniform in [0, 625K)
     from seed 6 until >= 625K rows enter the compaction) compacted by
     compact_table_mesh on 8 lanes of the card, one batched merge a
     window step; each held against a numpy oracle (exact; sums within
     rtol 1e-12), with no retry, fallback or cleanup error and the
     offset-value-code variant launched over 8 lanes at once; then the
     deduplicate table rescaled to 16 buckets: read back equal, every
     row in its formula's bucket, the schema's bucket option set, no row
     dropped.  It reports windows, packing, the window merges' seconds
     against the host run codes', and the launches by (B, N, L);
   - serving: serve_agg_312K, the reference serving benchmark's table
     at 312.5K rows under aggregation, whose every lookup merges a
     bucket on the card (4 cold buckets built at once from the server's
     handler threads, then 64 keep-alive clients of point gets), every
     answer held against a numpy oracle and the merged builds launching
     the offset-value-code variant from the handler threads.  It prints
     a {"serving": ...} line with the card's name and power limit;
   - serving_fleet: serve_fleet_4M, Paimon's query service for lookup
     joins (the Paimon docs' "Query Service" page, sys.query_service
     with a parallelism) over serve_bench.py's table at 4M rows on an
     object store (ObjectStoreFileIO over LocalObjectStoreBackend under
     LatencyInjectingObjectStoreBackend: 8 ms a call, 1% of GETs 20x
     slow) with the host-SSD tier, warm boot, hedged reads, breakers,
     and 4 replicas behind the router plus one in a process of its own
     (`serving_fleet` says what it drives): the cold and the
     warm-booted first lookups (zero reader builds, the SSD tier
     serving reads inside its bound), 64 clients over 256 tenants
     through the router and as smart clients (all 5 replicas answering,
     each tenant on its ring replica), the remote SIGKILLed and
     suspended within 4 health intervals plus 1 s, a serving writer's
     50K upserts read back on every replica before each commit (its
     commits stamping trace.context), a full compaction under 8 readers
     evicting the dropped files from both tiers, /scan, hedged against
     unhedged whole-table scans (identical rows, hedges within the
     cap), a 200 ms deadline over a stalled store raising within 1 s,
     and the fleet's /slo.  Every answer is held against a numpy
     oracle; no native probe may fall back; the flushes, the
     compaction and /scan must launch the kernel.  It prints a
     {"serving_fleet": ...} line with the card's name and power limit;
   - bucket_modes: primary-key tables as users create them without a
     `bucket` option, bench.py's rows (id BIGINT NOT NULL key, v1
     BIGINT, v2 DOUBLE, v3 INT), each read held against a numpy oracle:
     dyn_dedup_3.5M (dynamic buckets at dynamic-bucket.target-row-num's
     default of 2M: 7 commits of 500K uniform ids in [0, 4M) from one
     writer, a merge-on-read scan, a full compaction and a scan; the
     hash index against the rows: each id in one bucket, every bucket
     but the last at 2M hashes, the files' total the distinct 32-bit
     hashes; a fresh table object's 125K upserts of existing ids landing
     in their old buckets; then ADD COLUMN v4 DOUBLE, v3 INT -> BIGINT,
     RENAME v2 -> v2r and 2 commits of 250K upserts, a merge-on-read
     scan over runs of both schemas, a full compaction and a scan),
     xpart_upsert_125K (cross-partition upsert, partition dt INT of 4
     values: 125K keys in 4 commits, then a fresh table object's 4
     commits of 15.625K upserts, a quarter moving partition and some twice
     in one batch, so the global index bootstraps; each id once, in the
     partition of its last write, before and after a full compaction)
     and postpone_500K (bucket=-2: 500K rows in 4 commits that a scan does
     not see, then rescale_postpone at the postpone defaults and a
     scan).  It logs the dynamic assigner's and the index bootstrap's
     host seconds and each table's seconds, and prints a
     {"bucket_modes": ...} line;
   - maintenance: maint_daily_375K, a daily-partitioned table as the
     Paimon docs' Maintenance pages set one up (bench.py's columns plus
     dt STRING yyyyMMdd as the partition, primary key (dt, id),
     bucket=2, deduplicate, changelog-producer=input, inline
     compaction; daily watermark auto-tags keeping 4, snapshots kept
     10-20, decoupled changelog, partitions expiring after 3 days,
     success-file and done-partition mark-done, a counting commit
     callback): 24 streaming commits of 15,625 rows (6 days of 4 commits,
     the watermark 6 hours a commit, ids uniform in [0, 1M) a day, 2%
     -D, seed 7) with a consumer-id consumer polled each day; then each
     kept tag read, incremental reads between two tags and from a tag
     to the tip, expire_snapshots at the table's options (the files on
     disk exactly those the snapshots, tags and changelog entries
     reference; a fresh consumer from the earliest changelog), partition
     expiry of the 3 oldest days and an end-input batch commit marking
     its partitions done, a branch from the oldest tag with 31.25K upserts
     to an expired day, a fallback-branch read, fast_forward and
     rollback_to, compact_manifests, an orphan clean of planted files,
     fsck (deep), a lost data file found, repaired and merged around,
     and a final full compaction; every read held against a numpy
     oracle.  It prints a {"maintenance": ...} line;
   - write_read_planes: the read and write planes on bench.py's rows
     (id BIGINT NOT NULL key, v1 BIGINT, v2 DOUBLE, v3 INT), every read
     held against a numpy oracle: spill_bucket_24M (one bucket loaded
     as the Paimon docs' Write Performance page sets up
     write-buffer-spillable, write-only beside a dedicated compaction,
     everything else at the defaults: 24
     write_arrow calls of 1M ids uniform in [0, 12M) in one batch
     commit, so 8 spills of 3M rows, each merged on the card, then
     stream-merged into rolling L0 files at prepare-commit; the L0
     files sorted and disjoint, the spill directory gone, a scan, a full
     compaction and a read), spill_fold_coverage (1 MB spills, 4 file
     handles and an 8 MB disk cap: runs fold and early flushes land in
     L0; its files equal file for file to the same writes on the CPU),
     local_merge_hot_1M (bucket=4, local-merge-buffer-size=64mb, 8
     streaming commits of 125K rows, half on 1,000 hot ids: each commit's
     L0 rows are its distinct ids), plan_daily_600K (bench.py's columns
     plus dt STRING as the partition, key (dt, id), bucket=2, inline
     compaction, the plan cache and stats sidecar at their defaults:
     12 streaming commits of 50K rows over 12 days with a `latest`
     stream consumer, the cached plan after every commit equal to a
     cold plan of a fresh table object every 10th; then an INSERT
     OVERWRITE of a day, a late correction of an id band, a one-day and
     an id < 1000 plan served cached and walked cold by the sidecar
     prune, and rollback_to, each followed by a plan equal to a cold
     one) and faults_500K (bucket=4, 4 commits of 125K rows over a FileIO
     that fails every 20th data-file write and read once, retried
     under write.retry.* and read.retry.*, with write.stage.dir; the
     prefetch byte budget at 1 MiB; a data file's head zeroed: a read
     raises CorruptDataError, and skips it under
     scan.ignore-corrupt-files).  Retries equal the faults injected,
     the whole run retries nowhere else and no sidecar falls back; the
     spill merges and the local merger's folds must launch the kernel.
     It prints a {"write_read_planes": ...} line;
   - file_indexes: per-file indexes on primary-key tables as the Paimon
     docs' "Data File Index" pages set them up (bloom filter on id,
     bitmap and bit-sliced indexes on v3, a range bitmap on v1,
     file-index.in-manifest-threshold at its 500-byte default, so every
     blob is a `.index` sidecar), on bench.py's rows, every read held
     against a numpy oracle: fi_point_16M (bucket=4, write-only, 8
     commits of 2M ids uniform in [0, 8M) from seed 7, so 8 overlapping
     runs a bucket that key stats cannot prune; 10 point queries, 5
     written ids and 5 never written, each planned and read, with the
     files each plans; 10 plans of never-written ids timed with the
     sidecars read by ranges and read whole; `v3 = 100` planning
     nothing, `v3 = 42`, `v3 < 3` and `v1 > 2^39` read exactly; a full
     compaction whose outputs each carry a sidecar; the 10 queries
     again) and fi_rewrite_coverage
     (250K rows written without indexes, then rewrite_file_index with a
     bloom filter on id, and with force=True after the spec grew by the
     other indexes and a bloom filter on a string column; a write of
     indexed files whose data-file or sidecar write fails once and
     retries).  The write, the point queries and the compaction of
     fi_point_16M must launch the kernel.  It prints a
     {"file_indexes": ...} line;
   - append_tables: append tables as the Paimon docs' "Append Table",
     "Append Queue", "Deletion Vectors" and "Row Tracking" pages and the
     sort-compact action set them up, on bench.py's rows (seed 7),
     every read held against a numpy oracle: ap_log_16M (bucket=-1,
     deletion vectors on: 8 commits of 2^21 rows, a scan equal to the
     batches in commit order, a `v3 = 42` scan, two delete_where calls
     on 1% of the ids each, the lowest and the highest, each leaving the
     bucket's several splits one deletion-vector file, and a scan,
     compact(full=True) leaving no deletion vector
     and a scan, sort_compact(["id", "v3"], "zorder") launching the
     winner-select once a column at 2^24 for the curve's ranks, and an
     id band that plans fewer files than before the sort),
     ap_sort_coverage (2^17 rows with a STRING sharing 16-byte prefixes,
     a nullable INT and a DOUBLE with -0.0 and NaN: z-order on 3
     columns, so bit 63 is set, Hilbert on 1 and on 4, order on 2, each
     permutation on the card equal to its plain numpy version),
     ap_tracked_1M (row-tracking.enabled, 4 commits of 2^18 rows: two
     update_columns of v1 and a delete_by_row_ids on 1% of the row ids,
     the global index on id built with one launch and 10,000 lookups
     held against numpy, a compaction that keeps the row ids, reads
     with row ids) and ap_queue_coverage (bucket=4 by id with a bloom
     filter on id: 4 commits of 2^18 rows, each commit's streaming delta
     read, a compaction.min.file-num compaction, point predicates the
     file index skips).  Peak device memory stays under 4 GiB.  It
     prints an {"append_tables": ...} line;
   - formats_types: data-file formats and column types as the Paimon
     docs' "Blob", "Data Distribution" and file-format pages set them
     up (seed 7), every read held against a numpy oracle:
     blob_media_2G (bench.py's columns plus `meta VARIANT` and `image
     BLOB`, bucket=2, write-only: 8 commits of 4,096 rows, ids uniform
     in [0, 16,384), images of random bytes uniform in 8-120 KiB, about
     2 GiB in `.blob` sidecars; a merge-on-read scan with every image
     equal to its last writer's by hash, a projection without the image
     that reads no sidecar byte, variant_get(meta, '$.w') of every row,
     a delete_where of 1% of the ids, a full compaction whose sidecars
     hold exactly the winners' bytes, expire_snapshots and the orphan
     clean leaving no sidecar without its data file, $files against the
     files on disk and $audit_log, all +I), formats_coverage (one table
     per file.format avro, csv, json and mosaic, and a parquet table
     with file.format.per.level=0:avro, each 2 commits of 2^12 rows with
     ids in [0, 2^13): write, scan, full compaction and read, and the
     avro row codec's own rates) and surfaces_coverage (every system
     table on blob_media_2G and on the avro table, ANALYZE and
     $statistics against the oracle, $row_tracking's ranges contiguous
     on a row-tracked table, FormatTables over csv, json and parquet
     directories partitioned by dt, an ObjectTable over the media
     table's directory).  It prints a {"formats_types": ...} line;
   - catalog_sql: the catalog and SQL as the Paimon docs' "SQL DDL",
     "SQL Write", "SQL Query", "Procedures" and "Data Distribution"
     pages use them, everything through create_catalog(device="cuda")
     and SQLContext (seed 7), every answer held against a numpy oracle:
     sql_orders_16M (CREATE DATABASE and TABLEs: shop.orders with
     bench.py's columns, v1 in [0, 2^32), bucket=2, write-only, and the
     100-row dimension table shop.regions filled by SQL; 8 INSERT ...
     SELECT of a registered Arrow table of 2M rows, ids uniform in
     [0, 8M), about 220 MB of raw rows a bucket; count(*), a range of
     65,536 ids, a GROUP BY v3 and a star join with shop.regions;
     UPDATE of v3 = 42, DELETE of id < 80,000 and a MERGE INTO from 1M
     distinct ids uniform in [0, 16M), each followed by a read of every
     row; sys.create_tag, sys.compact, time travel to the tag,
     $snapshots, sys.expire_snapshots, sys.clone into backup.orders and
     sys.all_tables) and sql_coverage (sys.migrate_table of a hive-style
     parquet directory of 2^16 rows in 4 dt= partitions; an aggregation
     table made by DDL, 4 inserts of 2^16 rows read and compacted, so
     the offset-value-code variant launches; INSERT OVERWRITE, a view, a
     SQL function and a window query; the JDBC (sqlite) and the REST
     catalog on loopback, each creating, filling with 2^16 rows and
     reading back a table; a user without INSERT refused; `python -m
     paimon_tpu_torch --warehouse W sql` and `table read` as processes
     on the card).  K1 must launch in sql_orders_16M and K2 in
     sql_coverage.  It prints a {"catalog_sql": ...} line;
   - stream_cdc: CDC ingest and the streaming daemon as the Paimon
     docs' "Kafka CDC", "MySQL CDC" and "Changelog Producer" pages set
     them up, everything on the card, every answer held against a
     numpy oracle from seed 7: stream_orders_2M (a Debezium `orders`
     table, order_id BIGINT NOT NULL key, customer_id, status of 5
     values, amount, quantity INT, updated_at; bucket=4,
     changelog-producer=input, the stream.* options at their defaults;
     2M events in a JSONL file: a snapshot of 1M `r` events, then 1M
     changes, 60% `u` with before and after images, 30% `c` of new ids
     and 10% `d` over live ids; made by a process of their own ahead of
     the cell, and appended in chunks of 62,500 lines whenever the
     daemon's backlog falls under a chunk, so FileCdcSource tails a
     growing file; one StreamDaemon with its ingest, compaction and
     serve loops, a consumer thread materialising poll_changelog by id,
     and a query service in a process of its own answering a second
     consumer's /changelog polls; the daemon killed once the committed
     offset passes 1M and a new daemon recovering from the checkpoint;
     the table, both consumers' states, the committed offsets and
     identifiers (strictly rising, the last 1,999,999) and fsck checked)
     and stream_coverage (CdcDatabaseSync over a catalog on the card:
     3 tables of 2^14 events, an INT widened to BIGINT and an unseen
     column midway, a foreign database filtered out; canal, maxwell,
     ogg, dms and aliyun tables equal to the Debezium table of the same
     changes; a `date_format` computed partition; an aggregation table
     fed by a daemon, K2 in its compactions; the soak harness's short
     schedule of 3 kills and 3 storms; a loop forced to die leaving a
     flight dump; `python -m paimon_tpu_torch table stream` as a process
     tailing a file and stopped with SIGTERM, drained and equal to the
     oracle; `fleet trace --merge` over its spool and this process's).
     It prints a {"stream_cdc": ...} line and a {"stream": ...} line of
     the recorded figures;
   - search: vector, full-text and hybrid search (vector/, index/
     fulltext.py, the four sys.* search procedures) through
     create_catalog and SQLContext on the card.  vec_sift_1M, SIFT1M's
     shape from ann-benchmarks' sift-128-euclidean (1M base vectors of
     128 float32 dims, 10,000 queries, l2, recall@10) on a seeded
     mixture of 1,000 Gaussian clusters drawn on the card, in a
     `VECTOR<FLOAT, 128>` table of 2 buckets written in 4 commits: a
     read held against the rows written; vector_search of every query
     (l2) and of 1,000 (cosine, dot) over a BruteForceIndex on the card,
     500 of each held against a float64 numpy oracle under the
     exactness rule of tests/test_torch_vector.py; 3 CALL
     sys.vector_search against the Python API's rows; CALL
     sys.create_vector_index for IVF-PQ (m=16) and IVF-SQ, each loaded
     and queried 500 times (IVF-PQ at nprobe 16 with refine 100 and at
     nprobe 8 without), recall@10 at least the reference's test floors;
     a commit that makes the index stale and load_or_build's rebuild.
     search_coverage: HNSW through CALL sys.create_vector_index on 2^10
     vectors of 32 dims, IVF-Flat on 2^16 of 64, a BEIR-shaped docs
     table (2^15 docs of 8-64 Zipf words, row tracking) whose
     PersistedFullTextIndex is built, refreshed over two more commits
     and optimized, 50 queries held against a numpy BM25 oracle and the
     in-memory FullTextIndex (1 through CALL sys.full_text_search, which
     builds an in-memory index of every row a call), and CALL
     sys.hybrid_search under each ranker against rank_hybrid over the
     routes' own results.  The device programs of vector/ann.py
     (_topk_scores, _kmeans, the coarse _assign, _kmeans_batch,
     _pq_encode) are counted and timed between CUDA events against
     their bound (FLOPs at 67 TFLOP/s float32, bytes at 3.35 TB/s).  It
     prints a {"search": ...} line of the recorded figures;
   - lake_interop: the Iceberg export, the data loaders, the multi-writer
     ingest topology and the VFS through create_catalog on the card.
     ice_orders_16M (the Paimon docs' "Iceberg Compatibility",
     "Dedicated Compaction Job" and "Data Distribution" pages): bench.py's
     columns keyed by id, bucket=2, write-only; a StreamIngestTopology of
     2 writer threads commits 8 checkpoints of 2M ids uniform in [0, 8M)
     and a replay of the 8th that must commit nothing; a full compaction
     on the card; sync_iceberg through an IcebergRestCommitter to an
     in-process IcebergRESTCatalogServer; the rows read back by
     IcebergTable from the file metadata and from the REST catalog's
     metadata location, equal to the oracle (the last writer per id) and
     to the table's read; 2 checkpoints of 500K upserts and a sync
     without compaction that leaves the Iceberg view's files as they
     were, with the first export's snapshot as its CAS base; a second
     full compaction and sync, read back equal to the oracle; one epoch
     of jax_batches (65,536 rows, 4 columns, the masked tail) whose
     column sums on the card equal the oracle's; the VFS listing the
     table and opening a snapshot file byte for byte.  lake_coverage: an
     append table with deletion vectors whose export raises and writes
     nothing (its files hold the deleted rows), an ORC-topped table
     partitioned by dt through a DLF-signed REST catalog, the topology's
     round-robin append and dynamic-bucket refusal, split_read_tasks
     covering a table, and a DataLoader of 2 spawn workers seeing each
     of 2^18 rows once.  It prints a {"lake_interop": ...} line of the
     recorded figures;
   - multihost_planes: the multi-host planes (parallel/multihost.py,
     distributed.py, maintenance_plane.py, the stream daemon's plane
     mode) across OS processes that share the card: two hosts of one
     gloo group on 127.0.0.1 and a third process, host 1 restarted, all
     started with lake_interop so that their start overlaps it (the
     Paimon docs' "Concurrency Control" and "Data Distribution" pages,
     with the reference's benchmarks/multihost_bench.py and
     tests/multihost_soak.py rigs; seed 7).  mh_orders_16M: bench.py's
     columns keyed by id, v1 in [0, 2^32), bucket=4, write-only, the
     multihost.* keys at their defaults ('exchange' routing, 'cas'
     arbitration; buckets 0 and 2 owned by host 0, 1 and 3 by host 1);
     8 rounds in which each host writes 1M rows of its own (ids uniform
     in [0, 8M)), half routed to their owner by allgather_bytes, and
     commits under writer-p<i>; pinned-snapshot scans after rounds 4 and
     8, each host reading its assign_splits share; compact_table_mesh in
     each host over the groups it owns; rescale_buckets(8) and a pinned
     scan; fsck with its ownership check.  Every read is held per bucket
     against the last writers of every row regenerated on the card (a
     multiset digest), the two hosts pinning one snapshot id.
     mh_coverage: a 2^18-row table under 'coordinator' arbitration and
     'spmd' routing equal to the same rows under 'cas', a column of
     process_local_batch summed across the hosts against its oracle,
     which collectives gloo runs on the card's tensors, and the plane
     soak: a StreamDaemon with plane=MaintenancePlane in each host over
     2^16 events of 2^12 keys at tests/multihost_soak.py's options, host
     1 SIGKILLed at a third of the stream, host 0 taking its buckets
     over, host 1 restarted as a store-only rejoiner and readmitted,
     the table equal to the stream's state, each commit user's offsets
     rising, fsck clean and `fleet status` equal to the plane's view.
     Each process holds its first K1 launch of each shape against the
     plain version and reports its launches (counted in the `kernels`
     line) and its peak device memory.  It prints a
     {"multihost_planes": ...} line with the card;
   - analysis: the whole-program analysis plane (analysis/, `paimon
     lint`) on the card's machine: `python -m paimon_tpu_torch lint
     --json` in a process of its own over the checked-out package must
     exit 0 with no unsuppressed finding and the 15 rule ids plus the 2
     meta ids, equal to the same run in this process (both timed); a
     package named paimon_tpu_torch with one known-bad site for each
     rule (torch spellings for collectives, distributed-init and
     host-materialization), a reasonless and an orphaned marker, on
     which each rule reports exactly its site and `paimon lint` exits 1;
     and ROADMAP C.12 on the card: c12_stream_4M (bench.py's columns, 8
     commits of 2^19 rows, ids uniform in [0, 2^21) from seed 12,
     tpu.merge.stream-threshold-rows 2^20) compacted with every run's
     prefetch pump stalled for 3 s inside deadline_scope(200), which
     must raise DeadlineExceededError from the prefetch poll within
     1.5 s and commit nothing, then compacted unstalled with K1 launched
     and read back equal to the last-writer oracle.  It prints an
     {"analysis": ...} line with the card;
   Each phase reports rows/s, launches, the merge routes it took
   (ops/merge.PATH_COUNTS), peak device memory, the seconds spent in
   segment reductions (the port's reduction entry point timed between
   two synchronisations) and the milliseconds each stage histogram of
   metrics.py gained; a write, scan or compaction of a 100M-row
   table that took host merge routes only fails the run;
5. each kernel held against its plain PyTorch version on the card
   (exact equality) once at every shape (variant, lanes, rows, batched
   lanes) the main path gave it, on the inputs the first table to give
   it that shape gave there, and at further sizes of synthetic keys
   (among them 10 clustered coded runs, where the codes decide almost
   every pair).  At each such shape it reports the kernel's device time
   per launch (CUDA events around each of 10 launches queued behind a
   sleep on the card; `--compare-timers` holds them within 2% of the
   profiler's kernel durations at 2^27 rows and exits), the
   wrapper's host time per call (host clock over 300 calls, 50 above
   2^20 rows), the time of back-to-back calls between two
   CUDA events and the plain version's, beside the
   least time the bytes these inputs need take at the card's memory
   rate and the earlier design's time for the same shape; and the
   wrapper's host cost at n = 1024 split into allocation, the C entry
   point and the launch;
6. both variants held exactly against the plain version at edge sizes
   (n from 1 to 2^20 + 4 around every boundary of the rows a thread,
   a warp and a block take, L in 1, 2, 5, 8), and with inputs that are
   not 16-byte aligned; then the lane stride (B lanes of N rows in one
   launch: B in 1, 8, N in 1024, 2^18, L in 1, 2, 5, random lanes
   and full lanes of one key whose perms and codes run on across every
   boundary), exact and equal to B separate 1-D calls;
7. the changelog diff's key ranks on the card held exactly against
   np.unique on the host (the reference's computation), both timed;
8. merge_routes: every route of device_sorted_winners (device full with
   and without run codes, device packed, bitmask, host native fast,
   host numpy fast, host general up to 2^22, host OVC) at the main
   path's merge shapes (2 lanes, packed BIGINT keys, 10 sorted runs) at
   2^14 and 2^20, held equal under each route's contract and
   timed; the link rates at 8 MiB (the cost model's) and 256 MiB; the
   cost model's rates measured on this machine (the device's at 2^24,
   the host routes' at 2^20); the model's pick at
   each shape at a winner fraction of 1.0 and at dedup_bigint's.

The last lines of standard output are one JSON object per line: the
config-5 metrics, the device decode results, the mesh compaction, the
serving phase, the serving fleet, the merge routes, the bucket modes,
the maintenance phase, the read and write planes, the file indexes, the append tables,
the formats and types, the catalog and SQL, the streaming phase and
its figures, the search phase's figures, the lake phase's, the
multihost phase's, the analysis phase's, the stage split
(the summed milliseconds of the io.read, decode, encode, io.upload,
scan.merge, write.sort, commit and compaction histograms in the write,
scan and compaction of dedup_bigint, agg_sum_max_orc and
fi_point_16M, with the card), the phases, the kernels with their
launches on the main path and their times (`device_ms` and `host_us`
beside `ms`), then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# the earlier design's (one row a thread) kernel time at each shape it
# was timed at, as PERF.md's Findings record it (CUDA events around
# back-to-back wrapper calls), by (variant, lanes, n); "synthetic" marks
# synthetic inputs
EARLIER_MS = {("plain", 2, 1 << 27): 0.9565, ("plain", 2, 1 << 24): 0.1223,
          ("plain", 2, 1 << 22): 0.0338, ("plain", 2, 1 << 21): 0.0307,
          ("plain", 2, 1 << 20): 0.0297, ("ovc", 5, 1 << 18): 0.0290,
          ("ovc", 5, 1 << 15): 0.0244,
          ("plain", 2, 1 << 26, "synthetic"): 0.4828,
          ("plain", 2, (1 << 20) + 37, "synthetic"): 0.0405,
          ("ovc", 2, 1 << 24, "synthetic"): 0.1637}
KERNEL_NAME = "eq_next_kernel"     # the CUDA kernel's symbol


def cuda_ms(fn, iters: int) -> float:
    """Mean time of fn() over `iters` back-to-back calls between two CUDA
    events: the device time where the device is the slower side, the
    host's issue rate where the host is."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int = 20) -> list:
    """Each kernel's own device time per launch (ms), from the profiler's
    durations of the kernels named KERNEL_NAME in one session where each
    fn runs `iters` times in turn.  Run after every host-clock timing: a
    profiler session leaves later launches slower on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()

    def session(activities):
        t = [time.perf_counter()]
        with profile(activities=activities) as prof:
            t.append(time.perf_counter())
            for fn in fns:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            t.append(time.perf_counter())
        t.append(time.perf_counter())
        events = prof.events()
        t.append(time.perf_counter())
        spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                       for e in events
                       if KERNEL_NAME in e.name
                       and e.device_type == torch.autograd.DeviceType.CUDA)
        t.append(time.perf_counter())
        # where a session's seconds go: the profiler's start, the calls,
        # its stop (the trace's collection), the events' parse, the scan
        log(f"profiler session: start {t[1] - t[0]:.2f} s, "
            f"{len(fns)} x {iters} calls {t[2] - t[1]:.2f} s, stop "
            f"{t[3] - t[2]:.2f} s, events() {t[4] - t[3]:.2f} s "
            f"({len(events)} events), kernel spans {t[5] - t[4]:.2f} s")
        return spans
    # the card's activity alone (host op events cost seconds to gather);
    # with the host's too where that records no kernel
    spans = session([ProfilerActivity.CUDA])
    if len(spans) != iters * len(fns):
        log(f"profiler: {len(spans)} kernel spans with the card's activity "
            f"alone; again with the host's")
        spans = session([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if len(spans) != iters * len(fns):
        raise AssertionError(f"profiler recorded {len(spans)} launches of "
                             f"{KERNEL_NAME}, expected {iters * len(fns)}")
    return [sum(us for _, us in spans[k * iters:(k + 1) * iters])
            / iters / 1e3 for k in range(len(fns))]


SLEEP_CYCLES = 20_000_000         # ~10 ms of the card's clock


def event_ms(fns, iters: int = 10) -> list:
    """Each kernel's device time per launch (ms), between two CUDA events
    around each launch.  A sleep on the card holds the stream while the
    host queues every (event, launch, event), so no host time falls
    between an event and its launch.  Run after every host-clock timing,
    as device_ms is."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    out = []
    for fn in fns:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        out.append(sum(a.elapsed_time(b) for a, b in events) / iters)
    return out


def compare_timers() -> dict:
    """K1 and K2 on 2^27-row inputs (sorted 2-lane keys; 10 coded runs)
    timed both ways in one process: the profiler's kernel durations
    (device_ms, the kernel checks' earlier method) and CUDA events
    around each launch (event_ms, which it uses since).  Fails if they
    differ by more than 2%."""
    from paimon_tpu_torch.ops import kernels
    rng = np.random.default_rng(11)
    n = 1 << 27
    plain = sorted_int_keys(rng, n)
    coded = coded_runs(rng, n)
    fns = [lambda: kernels.eq_next_mask(plain[0], plain[1]),
           lambda: kernels.eq_next_mask(*coded, 2)]
    events = event_ms(fns)
    profiled = device_ms(fns, iters=10)
    out = {"n": n, "card": card_line()}
    for name, e, p in zip(("eq_next_mask", "eq_next_mask_ovc"), events,
                          profiled):
        out[name] = {"event_ms": e, "profiler_ms": p, "ratio": e / p}
    log(json.dumps({"timer_check": out}))
    bad = [k for k in ("eq_next_mask", "eq_next_mask_ovc")
           if abs(out[k]["ratio"] - 1) > 0.02]
    if bad:
        raise AssertionError(f"CUDA events and the profiler differ by more "
                             f"than 2% for {bad}: {out}")
    return out


def host_us(fn, calls: int = 1000) -> float:
    """Host clock per call over `calls` calls, synchronised at the end
    only: the wrapper's host cost where the device keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


class KernelStats:
    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.cases = []

    def record(self, launches: int) -> dict:
        # times at the largest shape the main path gave the kernel; the
        # host cost at its smallest, where the device keeps up
        main = [c for c in self.cases if c["main_path"]]
        if not main:
            raise AssertionError(f"{self.name}: no main-path shape checked")
        top = max(main, key=lambda c: c["n"] * c["lanes"])
        low = min(main, key=lambda c: c["n"] * c["lanes"])
        return {"name": self.name, "route": "cuda",
                "source": "paimon_tpu_torch/csrc/eq_next_mask.cu",
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in self.cases),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "n": top["n"], "lanes": top["lanes"],
                "device_ms": top["device_ms"],
                "host_us": low["host_us"], "host_us_n": low["n"],
                # the mesh's batched launches: b lanes of n / b rows
                "batched": [{k: c[k] for k in (
                    "batch", "n", "lanes", "launches", "ms", "device_ms",
                    "bound_ms", "plain_ms")}
                    for c in main if c["batch"] > 1]}


class LaunchCapture:
    """Records what the main path hands the kernel wrapper.

    For the length of the main-path run it wraps the references to
    kernels.eq_next_mask held by the merge (ops/merge.py) and by the
    changelog diff's key ranks (ops/diff.py): it counts the card's calls
    per (table, variant, lanes, n, caller, batched lanes b) and per
    calling thread's name, and keeps a host copy of the
    first call's inputs at each, so the kernels are checked and timed
    afterwards on exactly those inputs.  The wrapper and its launch
    counters are left as they are; the host time spent copying is kept
    out of the phase times."""

    def __init__(self):
        self.cases: dict = {}
        self.calls: dict = {}
        # (table, variant, thread-name prefix) -> launches: the serving
        # phase's launches come from the query server's handler threads
        self.threads: dict = {}
        self.where = ""
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _shim(self, caller: str):
        kernel = self._kernel

        def shim(lanes, invalid, ovc_off=None, perm=None,
                 num_key_lanes=None, seg_len=None):
            if not lanes.is_cuda:       # the CPU reference run
                return kernel(lanes, invalid, ovc_off, perm, num_key_lanes,
                              seg_len)
            n = lanes.shape[1]
            # batched merges (the mesh's bucket lanes): b lanes of
            # seg_len rows in one launch
            b = n // seg_len if seg_len and n else 1
            key = (self.where.split()[0],
                   "ovc" if ovc_off is not None else "plain",
                   lanes.shape[0], n, caller, b)
            thread = (key[0], key[1],
                      threading.current_thread().name.rsplit("_", 1)[0])
            with self._lock:
                self.calls[key] = self.calls.get(key, 0) + 1
                self.threads[thread] = self.threads.get(thread, 0) + 1
                if key not in self.cases:
                    t0 = time.perf_counter()
                    self.cases[key] = {
                        "where": f"{self.where}, {caller}",
                        "args": tuple(None if t is None else t.cpu()
                                      for t in (lanes, invalid, ovc_off,
                                                perm)),
                        "num_key_lanes": num_key_lanes,
                        "seg_len": seg_len if b > 1 else None}
                    self.seconds += time.perf_counter() - t0
            return kernel(lanes, invalid, ovc_off, perm, num_key_lanes,
                          seg_len)
        return shim

    def __enter__(self):
        from paimon_tpu_torch.ops import diff, kernels, merge
        self._modules = (merge, diff)
        self._kernel = kernels.eq_next_mask
        merge.eq_next_mask = self._shim("merge")
        diff.eq_next_mask = self._shim("diff ranks")
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.eq_next_mask = self._kernel


def needed_bytes(lanes, ovc_off, perm, seg_len=None):
    """(bytes, share of lane words) the function must move on these
    inputs: invalid of every row (with codes also ovc_off and perm), one
    byte out per row, and the lane words the compare needs.  A pair's
    lane l is needed only where the code leaves the pair open, the pair
    lies within one batched lane (`seg_len`) and lanes 0..l-1 are equal;
    a row's word is needed if either of its pairs needs it."""
    import torch
    num_lanes, n = lanes.shape
    per_row = 4 + 1 + (8 if ovc_off is not None else 0)
    open_pairs = torch.ones(n - 1, dtype=torch.bool, device=lanes.device)
    if ovc_off is not None:
        open_pairs = ~((perm[1:] == perm[:-1] + 1) & (ovc_off[1:] != -1))
    if seg_len is not None:
        open_pairs[seg_len - 1::seg_len] = False
    words = 0
    for lane in range(num_lanes):
        need = torch.zeros(n, dtype=torch.bool, device=lanes.device)
        need[:-1] |= open_pairs
        need[1:] |= open_pairs
        words += int(need.sum())
        open_pairs &= lanes[lane, :-1] == lanes[lane, 1:]
    return n * per_row + 4 * words, words / (num_lanes * n)


def exact(stats_name: str, label: str, args, num_key_lanes,
          seg_len=None) -> int:
    """Kernel against plain version on the card; raises on any
    difference, else returns the largest difference (0)."""
    import torch

    from paimon_tpu_torch.ops import kernels

    lanes, inv, off, perm = args
    got = kernels.eq_next_mask(lanes, inv, off, perm, num_key_lanes,
                               seg_len)
    want = kernels.eq_next_mask_plain(lanes, inv, off, perm, num_key_lanes,
                                      seg_len)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    if err or got.shape != want.shape:
        raise AssertionError(f"{stats_name} != plain on {label}")
    return err


def check_case(stats: KernelStats, label: str, args, num_key_lanes,
               main_path: bool, earlier_key=None, seg_len=None,
               launches: int = 0) -> dict:
    """Hold the kernel against its plain version on the card (exact
    equality), time the kernel's calls on the host clock and between
    CUDA events, time the plain version, and compute the bound; the
    device time per launch comes later (`report_device_times`), so the
    case keeps its inputs."""
    from paimon_tpu_torch.ops import kernels

    lanes, inv, off, perm = args
    err = exact(stats.name, label, args, num_key_lanes, seg_len)
    num_lanes, n = lanes.shape

    def kernel():
        return kernels.eq_next_mask(lanes, inv, off, perm, num_key_lanes,
                                    seg_len)

    iters = 25 if n >= 1 << 26 else 100
    ms = cuda_ms(kernel, iters)
    # above 2^20 rows the device, not the host, sets the call rate
    h_us = host_us(kernel, 300 if n <= 1 << 20 else 50)
    plain_ms = cuda_ms(lambda: kernels.eq_next_mask_plain(
        lanes, inv, off, perm, num_key_lanes, seg_len), max(5, iters // 10))
    nbytes, lane_share = needed_bytes(lanes, off, perm, seg_len)
    case = {"label": label, "n": n, "lanes": num_lanes,
            "batch": n // seg_len if seg_len else 1, "launches": launches,
            "main_path": main_path, "ms": ms, "host_us": h_us,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "lane_share": lane_share, "max_abs_err": err,
            "earlier_ms": EARLIER_MS.get(earlier_key), "call": kernel}
    stats.cases.append(case)
    return case


def host_breakdown(rng) -> dict:
    """The wrapper's host cost per call at the smallest main-path shape
    (n = 1024, L = 2), split by host_us into the output's allocation,
    the bound C entry point alone (n = 0 returns before the launch), the
    entry point with the launch, and the whole wrapper."""
    import torch

    from paimon_tpu_torch.ops import kernels

    lanes, inv, _, _ = sorted_int_keys(rng, 1024)
    kernels.eq_next_mask(lanes, inv)
    out = torch.empty_like(inv, dtype=torch.bool)
    call = [lanes.data_ptr(), 2, 0, inv.data_ptr(), None, None, 2, 1024,
            out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(lanes.device.index)]
    parts = {"alloc": host_us(lambda: torch.empty_like(inv,
                                                       dtype=torch.bool)),
             "entry": host_us(lambda: kernels._fn(*call))}
    call[2] = 1024
    parts["entry_launch"] = host_us(lambda: kernels._fn(*call))
    parts["wrapper"] = host_us(lambda: kernels.eq_next_mask(lanes, inv))
    rest = parts["wrapper"] - parts["alloc"] - parts["entry_launch"]
    log(f"wrapper host cost at n=1024, L=2: {parts['wrapper']:.2f} us/call "
        f"= allocation {parts['alloc']:.2f} + C entry through ctypes "
        f"{parts['entry']:.2f} + launch "
        f"{parts['entry_launch'] - parts['entry']:.2f} + checks and the "
        f"rest {rest:.2f}")
    return parts


def report_device_times(stats_list) -> None:
    """Device time per launch of every case, between CUDA events
    (event_ms; earlier a profiler session, whose start took most of
    its 9-11 s); then one line per case with all its numbers.  Drops the
    inputs."""
    import torch

    cases = [(st, c) for st in stats_list for c in st.cases]
    times = event_ms([c.pop("call") for _, c in cases], iters=10)
    for (st, c), dev_ms in zip(cases, times):
        c["device_ms"] = dev_ms
        earlier = c["earlier_ms"]
        share = c["bound_ms"] / c["device_ms"]
        # faster than HBM allows: the inputs stayed in L2 between launches,
        # where an HBM-rate bound says nothing about headroom
        share_text = f"{share:.1%} of" if share <= 1 else \
            "L2-resident, share n/a; HBM"
        log(f"{st.name} {c['label']} n={c['n']} L={c['lanes']}: exact; "
            f"device {c['device_ms']:.4f} ms = {share_text} bound "
            f"{c['bound_ms']:.4f} ms; host {c['host_us']:.2f} us/call; "
            f"back-to-back {c['ms']:.4f} ms (earlier design: "
            f"{'not timed' if earlier is None else f'{earlier:.4f} ms'}"
            f"); plain {c['plain_ms']:.4f} ms; lane words needed "
            f"{c['lane_share']:.1%}")
    torch.cuda.empty_cache()


def sorted_int_keys(rng, n: int):
    """Sorted 2-lane keys with ~2 rows per key and a padded tail, as a
    merge of one fixed-width key hands them over (sorted on the card)."""
    import torch
    keys = torch.sort(torch.from_numpy(rng.integers(
        0, n // 2, n, dtype=np.uint64).view(np.int64)).cuda()).values \
        .cpu().numpy().view(np.uint64)
    lanes = torch.from_numpy(np.stack([
        (keys >> np.uint64(32)).astype(np.uint32),
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
        .view(np.int32)).cuda()
    inv = torch.zeros(n, dtype=torch.int32, device="cuda")
    inv[n - n // 8:] = 1
    return lanes, inv, None, None


def coded_runs(rng, n: int, runs: int = 10, clustered: bool = False):
    """2-lane keys of `runs` sorted runs with their offset-value codes,
    then sorted as a merge sorts them.  Uniform keys overlap across runs,
    so sorted neighbours rarely come from one run; clustered runs each
    hold consecutive ids of a range of their own, so the codes decide
    almost every pair."""
    import torch

    from paimon_tpu_torch.ops.ovc import run_ovc_offsets
    per = n // runs
    if clustered:
        parts = [np.arange(k * per, (k + 1) * per, dtype=np.uint64)
                 for k in rng.permutation(runs)]
    else:
        parts = [np.sort(rng.integers(0, n // 2, per, dtype=np.uint64))
                 for _ in range(runs)]
    parts.append(np.zeros(n - per * runs, dtype=np.uint64))
    keys = np.concatenate(parts)
    mat = np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                    (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                   axis=1)
    starts = np.arange(0, per * runs + 1, per, dtype=np.int64)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:per * runs] = run_ovc_offsets(mat[:per * runs], starts)
    # valid rows by key, ties in row order, then the padded tail (the
    # stable sort on the card)
    order = np.concatenate([torch.sort(torch.from_numpy(
        keys[:per * runs].view(np.int64)).cuda(), stable=True).indices
        .cpu().numpy(), np.arange(per * runs, n)])
    valid = np.arange(n) < per * runs
    return (torch.from_numpy(np.ascontiguousarray(mat[order].T)
                             .view(np.int32)).cuda(),
            torch.from_numpy((~valid[order]).astype(np.int32)).cuda(),
            torch.from_numpy(off[order].view(np.int32)).cuda(),
            torch.from_numpy(order.astype(np.int32)).cuda())


def check_kernels(captured: LaunchCapture, k1: KernelStats,
                  k2: KernelStats) -> None:
    """Every shape (variant, lanes, n, batched lanes) the main path gave
    each kernel, once, on the inputs the first table to launch it at
    that shape gave (tables sorted by name), with the launches of every
    table at the shape; then further sizes of synthetic keys."""
    t0 = time.perf_counter()
    shapes: dict = {}
    for key in sorted(captured.cases,
                      key=lambda k: (k[1], k[0], k[3], k[2], k[4], k[5])):
        shapes.setdefault((key[1], key[2], key[3], key[5]), []).append(key)
    for keys in shapes.values():
        cases = [captured.cases.pop(k) for k in keys]
        case = cases[0]
        launches = sum(captured.calls[k] for k in keys)
        also = sorted({k[0] for k in keys[1:]} - {keys[0][0]})
        args = tuple(None if t is None else t.cuda() for t in case["args"])
        check_case(k2 if keys[0][1] == "ovc" else k1,
                   f"main path ({case['where']}, {launches} launches at "
                   f"this shape" + (f", also by {', '.join(also)}"
                                    if also else "") + ")", args,
                   case["num_key_lanes"], main_path=True,
                   earlier_key=keys[0][1:4], seg_len=case["seg_len"],
                   launches=launches)
        del cases
    t1 = time.perf_counter()
    host_breakdown(np.random.default_rng(17))
    rng = np.random.default_rng(11)
    for n in (1 << 24, (1 << 20) + 37):
        check_case(k1, "sorted int keys", sorted_int_keys(rng, n), 2,
                   main_path=False, earlier_key=("plain", 2, n, "synthetic"))
    check_case(k2, "10 coded runs of int keys", coded_runs(rng, 1 << 22), 2,
               main_path=False, earlier_key=("ovc", 2, 1 << 22, "synthetic"))
    check_case(k2, "10 clustered coded runs of int keys",
               coded_runs(rng, 1 << 22, clustered=True), 2,
               main_path=False)
    t2 = time.perf_counter()
    report_device_times([k1, k2])
    log(f"kernel checks: {len(shapes)} main-path shapes {t1 - t0:.1f} s, "
        f"host breakdown and synthetic keys {t2 - t1:.1f} s, event-timed "
        f"device times {time.perf_counter() - t2:.1f} s")


EDGE_SIZES = (1, 2, 3, 4, 5, 8, 31, 32, 33, 124, 127, 128, 129, 132, 252,
              256, 260, 508, 512, 516, 1020, 1023, 1024, 1025, 1028, 2044,
              2048, 2052, (1 << 20) + 3, (1 << 20) + 4)
# ((1 << 20) + 37 and (1 << 21) + 4 until the lake phase came)
EDGE_LANES = (1, 2, 5, 8)


def lane_order_key(lanes: np.ndarray) -> np.ndarray:
    """int64 key of rows of lane values in {0, 1, 2} whose order is the
    rows' lexicographic order (lane 0 first): a stable argsort of it
    orders as np.lexsort of the lanes does."""
    key = np.zeros(len(lanes), dtype=np.int64)
    for lane in range(lanes.shape[1]):
        key = key * 3 + lanes[:, lane]
    return key


def edge_inputs(rng, n: int, num_lanes: int):
    """Host inputs in sorted order as a merge hands them over: up to four
    sorted runs of keys drawn from {0, 1, 2} per lane (so neighbours are
    often equal), concatenated and sorted by (invalid, lanes), with an
    invalid padded tail; (lanes[L, n], invalid, ovc_off, perm) as int32."""
    from paimon_tpu_torch.ops.ovc import run_ovc_offsets
    real = n - int(rng.integers(0, n // 8 + 1))
    lanes = rng.integers(0, 3, (n, num_lanes)).astype(np.uint32)
    lanes[real:] = 0
    cuts = np.sort(rng.choice(np.arange(1, real), min(3, real - 1),
                              replace=False)) if real > 1 else []
    starts = np.concatenate([[0], cuts, [real]]).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        lanes[a:b] = lanes[a:b][np.argsort(lane_order_key(lanes[a:b]),
                                           kind="stable")]
    invalid = (np.arange(n) >= real).astype(np.uint32)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:real] = run_ovc_offsets(lanes[:real], starts)
    order = np.argsort(invalid.astype(np.int64) * 3 ** num_lanes
                       + lane_order_key(lanes), kind="stable")
    return (np.ascontiguousarray(lanes[order].T).view(np.int32),
            invalid[order].view(np.int32), off[order].view(np.int32),
            order.astype(np.int32))


def on_card(a, shift: int = 0, device: str = "cuda"):
    """A contiguous copy of int32 `a` on the card, starting `shift` words
    into a buffer."""
    import torch
    buf = torch.empty(a.size + shift, dtype=torch.int32, device=device)
    t = buf[shift:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def check_edges() -> int:
    """Both variants exact at every edge size and lane count, and with
    inputs that start 4 bytes past a 16-byte boundary; returns the
    number of cases checked."""
    rng = np.random.default_rng(13)
    cases = 0
    for n in EDGE_SIZES:
        for num_lanes in EDGE_LANES:
            host = edge_inputs(rng, n, num_lanes)
            shifts = (0, 1) if n in (1024, 2048, (1 << 20) + 4) else (0,)
            for shift in shifts:
                lanes, inv, off, perm = (on_card(a, shift) for a in host)
                where = f"edge n={n} L={num_lanes} shift={shift}"
                exact("eq_next_mask", where, (lanes, inv, None, None),
                      num_lanes)
                exact("eq_next_mask_ovc", where, (lanes, inv, off, perm),
                      num_lanes)
                cases += 2
    return cases


SEG_BATCHES = (1, 8)             # (1, 3, 8) until the formats phase came
SEG_ROWS = (1024, 1 << 18)       # (1024, 2^20) until the formats phase came
SEG_LANES = (1, 2, 5)


def seg_inputs(rng, b: int, n: int, num_lanes: int, kind: str):
    """b batched lanes of n rows each, end to end, as (lanes[L, b*n],
    invalid, ovc_off, perm) int32 host arrays.  "random": each lane
    edge_inputs' sorted runs with their own perm and codes; "equal":
    full lanes of one key (0), perms counting on across every lane
    boundary and codes claiming equality everywhere, so only the lane
    stride may cut a pair there."""
    if kind == "random":
        parts = [edge_inputs(rng, n, num_lanes) for _ in range(b)]
        return (np.ascontiguousarray(np.concatenate([p[0] for p in parts],
                                                    axis=1)),
                *(np.concatenate([p[k] for p in parts]) for k in (1, 2, 3)))
    return (np.zeros((num_lanes, b * n), dtype=np.int32),
            np.zeros(b * n, dtype=np.int32),
            np.full(b * n, num_lanes, dtype=np.int32),
            np.arange(b * n, dtype=np.int32))


def check_seg_edges(device: str = "cuda") -> int:
    """The lane stride (seg_len) of both variants: for each batch B,
    lane rows N and key lanes L, the kernel exact against the plain
    version with the stride, and the plain version with the stride
    equal to B separate 1-D calls (jax.vmap's semantics); returns the
    number of cases checked."""
    import torch

    from paimon_tpu_torch.ops import kernels

    rng = np.random.default_rng(29)
    cases = 0
    for b in SEG_BATCHES:
        for n in SEG_ROWS:
            for num_lanes in SEG_LANES:
                for kind in ("random", "equal"):
                    lanes, inv, off, perm = (on_card(a, device=device)
                                             for a in seg_inputs(
                                                 rng, b, n, num_lanes, kind))
                    where = f"seg_len={n} B={b} L={num_lanes} {kind}"
                    for name, args in (("eq_next_mask",
                                        (lanes, inv, None, None)),
                                       ("eq_next_mask_ovc",
                                        (lanes, inv, off, perm))):
                        if device == "cuda":
                            exact(name, where, args, num_lanes, n)
                        la, iv, of, pm = args
                        whole = kernels.eq_next_mask_plain(
                            la, iv, of, pm, num_lanes, n)
                        apart = torch.cat([kernels.eq_next_mask_plain(
                            la[:, k * n:(k + 1) * n], iv[k * n:(k + 1) * n],
                            None if of is None else of[k * n:(k + 1) * n],
                            None if pm is None else pm[k * n:(k + 1) * n],
                            num_lanes) for k in range(b)])
                        if not torch.equal(whole, apart):
                            raise AssertionError(f"{name} {where}: the "
                                                 f"stride differs from B "
                                                 f"1-D calls")
                        cases += 1
    return cases


def check_sorted_winners() -> None:
    from paimon_tpu_torch.ops.merge import device_sorted_winners

    rng = np.random.default_rng(5)
    n = 2 << 20                      # 4M until the search phase came
    lanes = rng.integers(0, 1 << 21, (n, 2), dtype=np.uint64) \
        .astype(np.uint32)
    seq = rng.permutation(n).astype(np.int64)
    runs = 10
    starts = np.linspace(0, n, runs + 1).astype(np.int64)
    sorted_runs = np.concatenate([
        lanes[a:b][np.lexsort(lanes[a:b].T[::-1])]
        for a, b in zip(starts[:-1], starts[1:])])
    cases = [("keep=last", dict(lanes=lanes, keep="last")),
             ("keep=first", dict(lanes=lanes, keep="first")),
             ("keep=last winners-only", dict(lanes=lanes, keep="last",
                                             winners_only=True)),
             ("ovc full order", dict(lanes=sorted_runs, keep="last",
                                     run_starts=starts))]
    for name, kw in cases:
        lanes_arg = kw.pop("lanes")
        t0 = time.perf_counter()
        on_card = device_sorted_winners(lanes_arg, seq, device="cuda", **kw)
        t1 = time.perf_counter()
        on_cpu = device_sorted_winners(lanes_arg, seq, device="cpu", **kw)
        t2 = time.perf_counter()
        for what, a, b in zip(("perm", "winner", "prev"), on_card, on_cpu):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"device_sorted_winners {name}: {what} "
                                     f"differs between cuda and cpu")
        log(f"device_sorted_winners n={n} {name}: cuda == cpu "
            f"(cuda {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s host clock)")


def check_segment_reductions(device: str = "cuda") -> None:
    """The port's segment reductions on `device` against the same calls
    on the CPU, 2M rows in segments of 1 to 8: integers and float
    max/min exact (NaN, infinities and -0.0 among the floats; a NaN's
    payload may differ), float sum and product within rtol 1e-12
    (float64) and 1e-5 (float32); says whether the float folds were
    bit-identical too."""
    from paimon_tpu_torch.ops.agg import Segments, segment_reduce

    rng = np.random.default_rng(19)
    n = 1 << 21                      # 2^22 until the search phase came
    seg = np.repeat(np.arange(n), rng.integers(1, 9, n))[:n]
    num = int(seg[-1]) + 1
    card, cpu = Segments(seg, num, device), Segments(seg, num, "cpu")
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
    for dtype in (np.int32, np.int64, np.float32, np.float64):
        if np.issubdtype(dtype, np.floating):
            vals = rng.standard_normal(n).astype(dtype)
            pick = rng.random(n) < 0.01
            vals[pick] = specials[rng.integers(0, 5, pick.sum())]
        else:
            vals = rng.integers(-1000, 1000, n).astype(dtype)
        bits = []
        for op in ("sum", "prod", "max", "min"):
            got = segment_reduce(vals, op, card)
            want = segment_reduce(vals, op, cpu)
            # bit for bit, but for the payload of a NaN
            itype = np.uint64 if got.itemsize == 8 else np.uint32
            nan = np.isnan(got) & np.isnan(want) \
                if np.issubdtype(dtype, np.floating) else False
            same = bool(((got.view(itype) == want.view(itype)) | nan).all())
            if not same:
                if op in ("max", "min") or \
                        not np.issubdtype(dtype, np.floating):
                    raise AssertionError(f"segment {op} of {dtype.__name__}:"
                                         f" card != cpu")
                rtol = 1e-12 if dtype == np.float64 else 1e-5
                if not np.allclose(got, want, rtol=rtol, atol=0.0,
                                   equal_nan=True):
                    raise AssertionError(f"segment {op} of {dtype.__name__}:"
                                         f" card beyond rtol {rtol} of cpu")
            bits.append(f"{op} {'bit-identical' if same else 'within rtol'}")
        log(f"segment reductions of {dtype.__name__}, {n} rows in {num} "
            f"segments: {device} against cpu: {', '.join(bits)}")


def dense_ids(ids: np.ndarray) -> bool:
    """Integer ids in [0, 2n + 2^20): gathered by id without a sort."""
    return np.issubdtype(ids.dtype, np.integer) and len(ids) > 0 and \
        ids.min() >= 0 and ids.max() < 2 * len(ids) + (1 << 20)


def last_writer_oracle(ids: np.ndarray, order=None) -> np.ndarray:
    """Global row index of the last write of each id, in id order
    (`order`: a stable argsort of `ids`, when already at hand).  Dense
    ids take each id's largest row number, scattered by id, in place
    of the sort."""
    if order is None and dense_ids(ids):
        last = np.full(int(ids.max()) + 1, -1, dtype=np.int64)
        np.maximum.at(last, ids, np.arange(len(ids)))
        return last[last >= 0]
    if order is None:
        order = np.argsort(ids, kind="stable")
    s = ids[order]
    last = np.flatnonzero(np.r_[s[1:] != s[:-1], True])
    return order[last]


def dense_positions(what: str, got_ids: np.ndarray,
                    want_ids: np.ndarray) -> np.ndarray:
    """For increasing dense integer ids `want_ids` and as many ids read
    back: each read row's position in `want_ids`, found by a scatter by
    id in place of a sort; raises unless the read ids are exactly
    `want_ids` in some order."""
    pos = np.full(int(want_ids[-1]) + 1 if len(want_ids) else 0, -1,
                  dtype=np.int64)
    pos[want_ids] = np.arange(len(want_ids))
    if len(got_ids) and (got_ids.min() < 0 or got_ids.max() >= len(pos)):
        raise AssertionError(f"{what}: an id outside the oracle's")
    at = pos[got_ids]
    if (at < 0).any() or len(at) and \
            np.bincount(at, minlength=len(want_ids)).max() != 1:
        raise AssertionError(f"{what}: the ids differ from the oracle's")
    return at


CARD_CHECK_ROWS = 1 << 22        # reads this long are compared on the card


def to_card(a: np.ndarray):
    """A copy of host array `a` on the card (Arrow's read-only buffers
    are only read here)."""
    import warnings

    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")


def card_positions(what: str, got_ids, want_ids):
    """dense_positions on the card, for tensors there; None when
    `want_ids` is not increasing."""
    import torch
    n = len(want_ids)
    if n and not bool((want_ids[1:] > want_ids[:-1]).all()):
        return None
    pos = torch.full((int(want_ids[-1]) + 1 if n else 0,), -1,
                     dtype=torch.int64, device=want_ids.device)
    pos[want_ids] = torch.arange(n, device=want_ids.device)
    if len(got_ids) and (int(got_ids.min()) < 0 or
                         int(got_ids.max()) >= len(pos)):
        raise AssertionError(f"{what}: an id outside the oracle's")
    at = pos[got_ids]
    if len(at) and (bool((at < 0).any()) or
                    int(torch.bincount(at, minlength=n).max()) != 1):
        raise AssertionError(f"{what}: the ids differ from the oracle's")
    return at


def same_column_on_card(got_col, want) -> bool:
    """A read column (Arrow, no nulls) equal to `want` on the card."""
    return got_col.null_count == 0 and bool(
        (to_card(got_col.to_numpy()) == want).all())


def check_rows(what: str, got, cols: dict, win: np.ndarray,
               key: str) -> None:
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch
    if got.num_rows != len(win):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(win)}")
    full_key = cols[key]
    rows = np.flatnonzero(win) if win.dtype == bool else win
    if len(rows) >= CARD_CHECK_ROWS and torch.cuda.is_available() and \
            all(not isinstance(c, pa.Array) for c in cols.values()) and \
            dense_ids(full_key):
        # the same check on the card: each read row's oracle row by a
        # scatter by id, every column gathered and compared there
        src = to_card(rows)
        at = card_positions(what, to_card(got.column(key).combine_chunks()
                                          .to_numpy()),
                            to_card(full_key)[src])
        if at is not None:
            src = src[at]
            for name, full in cols.items():
                if not same_column_on_card(got.column(name)
                                           .combine_chunks(),
                                           to_card(full)[src]):
                    raise AssertionError(f"{what}: column {name} differs "
                                         f"from the oracle")
            return
    if not isinstance(full_key, pa.Array) and dense_ids(full_key) and \
            (np.diff(full_key[rows]) > 0).all():
        # dense integer keys in key order: each read row's oracle row by
        # a scatter by id
        at = rows[dense_positions(what, got.column(key).combine_chunks()
                                  .to_numpy(), full_key[rows])]
        for name, full in cols.items():
            col = got.column(name).combine_chunks()
            if isinstance(full, pa.Array):
                same = col.equals(full.take(pa.array(at)))
            else:
                same = np.array_equal(col.to_numpy(zero_copy_only=False),
                                      full[at])
            if not same:
                raise AssertionError(f"{what}: column {name} differs from "
                                     f"the oracle")
        return
    got = got.take(pc.sort_indices(got, sort_keys=[(key, "ascending")]))
    for name, full in cols.items():
        col = got.column(name).combine_chunks()
        want = full.take(pa.array(win)) if isinstance(full, pa.Array) \
            else full[win]
        if isinstance(full, pa.Array):
            same = col.equals(want)
        else:
            same = np.array_equal(col.to_numpy(zero_copy_only=False), want)
        if not same:
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"oracle")


def agg_oracle(cols: dict) -> dict:
    """Config 4's aggregation by numpy alone: per id (in id order) the
    sum of v1, the max of v2 and the max of v3, scattered by id for
    dense ids, else by reduceat over the id-sorted rows."""
    ids = cols["id"]
    if dense_ids(ids):
        k = int(ids.max()) + 1
        seen = np.zeros(k, dtype=bool)
        seen[ids] = True
        out = {"id": np.flatnonzero(seen)}
        for c, ufunc, start in (("v1", np.add, 0),
                                ("v2", np.maximum, -np.inf),
                                ("v3", np.maximum,
                                 np.iinfo(cols["v3"].dtype).min)):
            acc = np.full(k, start, dtype=cols[c].dtype)
            ufunc.at(acc, ids, cols[c])
            out[c] = acc[seen]
        return out
    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    return {"id": ids[starts],
            "v1": np.add.reduceat(cols["v1"][order], starts),
            "v2": np.maximum.reduceat(cols["v2"][order], starts),
            "v3": np.maximum.reduceat(cols["v3"][order], starts)}


def check_agg(what: str, got, want: dict) -> None:
    """Row for row, every column exactly equal to the oracle's (on the
    card for long reads)."""
    import pyarrow.compute as pc
    import torch
    if got.num_rows != len(want["id"]):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(want['id'])}")
    if len(want["id"]) >= CARD_CHECK_ROWS and torch.cuda.is_available() \
            and dense_ids(want["id"]):
        at = card_positions(what, to_card(got.column("id").combine_chunks()
                                          .to_numpy()), to_card(want["id"]))
        if at is not None:
            for name, col in want.items():
                if not same_column_on_card(got.column(name)
                                           .combine_chunks(),
                                           to_card(col)[at]):
                    raise AssertionError(f"{what}: column {name} differs "
                                         f"from the oracle")
            return
    if dense_ids(want["id"]) and (np.diff(want["id"]) > 0).all():
        at = dense_positions(what, got.column("id").combine_chunks()
                             .to_numpy(), want["id"])
        for name, col in want.items():
            have = got.column(name).combine_chunks()
            if have.null_count or not np.array_equal(have.to_numpy(),
                                                     col[at]):
                raise AssertionError(f"{what}: column {name} differs from "
                                     f"the oracle")
        return
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    for name, col in want.items():
        have = got.column(name).combine_chunks()
        if have.null_count or not np.array_equal(have.to_numpy(), col):
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"oracle")


class ReduceTimer:
    """Seconds the aggregation engines spend in segment reductions.

    For as long as it is entered it wraps the port's reduction entry
    point (ops.agg.segment_reduce) and the upload of each merge's
    segment ids (ops.agg.Segments), synchronising the card before and
    after each call, and sums their host-clock time; the two merge
    threads of a streamed compaction may overlap, so the sum can exceed
    the time they cover."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._lock = threading.Lock()

    def _timed(self, fn):
        import torch

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            with self._lock:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.ops import agg
        self._agg = agg
        self._reduce = agg.segment_reduce
        self._init = agg.Segments.__init__
        agg.segment_reduce = self._timed(self._reduce)
        agg.Segments.__init__ = self._timed(self._init)
        return self

    def __exit__(self, *exc):
        self._agg.segment_reduce = self._reduce
        self._agg.Segments.__init__ = self._init


# the stage histograms of metrics.py that the spans of the format, read,
# write, commit and compaction planes feed: summed milliseconds, over
# every thread that ran the stage
STAGE_HISTOGRAMS = {"io.read": ("io", "read_ms"),
                    "decode": ("io", "decode_ms"),
                    "encode": ("io", "encode_ms"),
                    "io.upload": ("io", "upload_ms"),
                    "scan.merge": ("scan", "merge_ms"),
                    "write.sort": ("write", "sort_ms"),
                    "commit": ("commit", "duration_ms"),
                    "compaction": ("compaction", "duration_ms")}


def stage_sums() -> dict:
    """Cumulative milliseconds of each stage histogram so far."""
    from paimon_tpu_torch.metrics import global_registry
    reg = global_registry()
    return {k: reg.group(g).histogram(m).total_sum
            for k, (g, m) in STAGE_HISTOGRAMS.items()}


def stage_split(phases: list, tables) -> dict:
    """{table: {phase: {"s": host seconds, stage: summed ms}}} for the
    write, scan and compaction of each table."""
    return {t: {p["phase"]: {"s": p["s"], **p.get("stages_ms", {})}
                for p in phases if p["table"] == t
                and p["phase"] in ("write", "scan", "compact")}
            for t in tables}


class Recorder:
    """Runs the phases of the main path: each timed on the host clock
    between two synchronisations of the card, with its kernel launches,
    segment-reduction seconds and peak device memory, appended to
    `phases` and logged."""

    def __init__(self, counts, phases: list, capture: LaunchCapture,
                 reducer: ReduceTimer):
        self.counts = counts
        self.phases = phases
        self.capture = capture
        self.reducer = reducer

    def run(self, name: str, what: str, rows, device, fn):
        """`rows`: the phase's row count, or a callable that gives it
        after the phase."""
        import torch

        on_card = device.type == "cuda"
        capture, reducer = self.capture, self.reducer
        from paimon_tpu_torch.ops import merge
        capture.where = f"{name} {what}"
        before = self.counts()
        stages = stage_sums()
        routes = dict(merge.PATH_COUNTS)
        copied = capture.seconds
        reduced, reduce_calls = reducer.seconds, reducer.calls
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - (capture.seconds - copied)
        launches = tuple(a - b for a, b in zip(self.counts(), before))
        if callable(rows):
            rows = rows()
        self.add(name, what, rows, device, dt, launches,
                 reducer.seconds - reduced, reducer.calls - reduce_calls,
                 routes={k: v - routes[k]
                         for k, v in merge.PATH_COUNTS.items()},
                 stages_ms={k: v - stages[k]
                            for k, v in stage_sums().items()})
        return out

    def add(self, name: str, what: str, rows: int, device, seconds: float,
            launches, seg_reduce_s: float = 0.0, seg_reduce_calls: int = 0,
            **extra) -> dict:
        """Record one phase measured by the caller (peak device memory
        since the last reset of the card's peak)."""
        import torch

        rec = {"table": name, "phase": what, "device": device.type,
               "rows": rows, "s": seconds, "rows_per_s": rows / seconds,
               "launches_plain": launches[0], "launches_ovc": launches[1],
               "seg_reduce_s": seg_reduce_s,
               "seg_reduce_calls": seg_reduce_calls,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if device.type == "cuda" else None), **extra}
        self.phases.append(rec)
        peak = "n/a" if rec["peak_gib"] is None \
            else f"{rec['peak_gib']:.2f} GiB"
        log(f"  {name} {what} ({device.type}): {rows} rows in "
            f"{seconds:.2f} s = {rows / seconds:,.0f} rows/s; launches "
            f"plain={launches[0]} ovc={launches[1]}; segment reductions "
            f"{seg_reduce_s:.3f} s in {seg_reduce_calls} calls; peak "
            f"device memory {peak}"
            + (f"; merge routes {extra['routes']}" if "routes" in extra
               else ""))
        return rec


def drive_table(path, schema, batches, check, rec: Recorder,
                row_kinds=None, device=None,
                repeat_scan: bool = False, after_write=None) -> dict:
    """create -> write one commit per batch -> merge-on-read scan (twice
    with `repeat_scan`) -> compact(full=True) -> read back, on `device`
    (None: the card); hands every read to `check(what, table)` and
    records each phase through `rec`; calls `after_write()` between the
    write and the scan.  Returns the reads by phase."""
    from paimon_tpu_torch.table import FileStoreTable

    rows = sum(b.num_rows for b in batches)
    name = os.path.basename(path)
    table = FileStoreTable.create(path, schema, device=device)

    def phase(what, fn):
        return rec.run(name, what, rows, table.device, fn)

    def write():
        for k, b in enumerate(batches):
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b, None if row_kinds is None else row_kinds[k])
                wb.new_commit().commit(w.prepare_commit())

    phase("write", write)
    if after_write is not None:
        after_write()
    reads = {}
    for what in ("scan", "scan again") if repeat_scan else ("scan",):
        reads[what] = phase(what, table.to_arrow)
        check(f"{name} merge-on-read {what}", reads[what])
    if phase("compact", lambda: table.compact(full=True)) is None:
        raise AssertionError("full compaction committed nothing")
    reads["read"] = phase("read", table.to_arrow)
    check(f"{name} read after compaction", reads["read"])
    return reads


def bigint_batches(rows: int, runs: int = 10, seed: int = 7):
    """bench.py's build_table batches: `runs` commits of uniform ids in
    [0, rows/2), v1 BIGINT, v2 DOUBLE, v3 INT, from `seed`: each batch
    from a generator of its own (spawned from `seed`), made in threads
    (numpy's generators release the GIL while they fill arrays)."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    per_run = rows // runs

    def batch(seq):
        rng = np.random.default_rng(seq)
        return pa.table({
            "id": pa.array(rng.integers(0, rows // 2, per_run), pa.int64()),
            "v1": pa.array(rng.integers(0, 1 << 40, per_run), pa.int64()),
            "v2": pa.array(rng.random(per_run), pa.float64()),
            "v3": pa.array(rng.integers(0, 100, per_run).astype(np.int32),
                           pa.int32())})
    with ThreadPoolExecutor(min(runs, os.cpu_count() or 1)) as pool:
        return list(pool.map(batch, np.random.SeedSequence(seed)
                             .spawn(runs)))


def oracle_child(rows: int, out: str) -> None:
    """The 100M-row cells' numpy oracles in a process of their own, run
    as `python -c "import chip_smoke; chip_smoke.oracle_child(...)"` so
    that their ufunc.at passes (which hold the GIL) overlap the dedup
    write: the same batches made again from the seed, dedup_bigint's
    last writers and config 4's sums and maxima saved as .npy files in
    `out`, then an empty `done` file."""
    batches = bigint_batches(rows)
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    del batches
    np.save(os.path.join(out, "win.npy"), last_writer_oracle(cols["id"]))
    for c, v in agg_oracle(cols).items():
        np.save(os.path.join(out, f"agg_{c}.npy"), v)
    open(os.path.join(out, "done"), "w").close()


class OracleChild:
    """oracle_child in a process started now; `get()` waits for it and
    returns (last writers, the aggregation oracle)."""

    def __init__(self, rows: int, work: str):
        self.out = os.path.join(work, "oracles")
        os.makedirs(self.out)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke."
             f"oracle_child({rows}, {self.out!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.PIPE, text=True)
        self.got = None

    def get(self) -> tuple:
        if self.got is None:
            t0 = time.perf_counter()
            err = self.proc.communicate()[1]
            if self.proc.returncode or not os.path.exists(
                    os.path.join(self.out, "done")):
                raise AssertionError(f"the oracle process failed "
                                     f"({self.proc.returncode}): {err}")
            load = lambda f: np.load(os.path.join(self.out, f))  # noqa: E731
            self.got = (load("win.npy"), {c: load(f"agg_{c}.npy")
                                          for c in ("id", "v1", "v2", "v3")})
            log(f"numpy oracles of the 100M-row cells: ready "
                f"{time.perf_counter() - self.t0:.1f} s after their "
                f"process started, waited for {time.perf_counter() - t0:.1f}"
                f" s")
        return self.got

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def string_key_batches(rows: int = 1 << 16, runs: int = 10, seed: int = 7):
    """Kernel coverage: string keys, 1 in 64 ids longer than the 16-byte
    key prefix, so merges take the full-order path with run codes."""
    import pyarrow as pa
    per = rows // runs
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(runs):
        ids = rng.integers(0, rows // 2, per)
        names = [f"user-{i:09d}" + ("-profile-archive" if i % 64 == 0
                                    else "") for i in ids.tolist()]
        out.append(pa.table({
            "name": pa.array(names, pa.string()),
            "v1": pa.array(rng.integers(0, 1 << 40, per), pa.int64())}))
    return out


PU_MEMBERS = [f"m{i}" for i in range(8)]
PU_PLAIN = [f"c{i}" for i in range(52)]
PU_TYPES = ("BIGINT", "DOUBLE", "INT", "STRING")


COVERAGE_KEYS = 1 << 14          # keys of the partial-update and
                                 # changelog-producer coverage tables
                                 # (2^16 until the stream phase came)


def partial_update_table(keys: int = COVERAGE_KEYS, commits: int = 5,
                         seed: int = 7):
    """Config 3's shape cut to a coverage check: a partial-update table
    of 64 columns (id; sequence field g with its group of 8 members; a
    DOUBLE sum column and an INT count column; 52 plain columns), one
    commit per pass over all `keys` keys in a random order.  Every
    commit writes the key, g and its members, the sum and count
    columns, and 14 plain columns of its own (a window that moves 14
    columns a commit), nulls elsewhere; 1 row in 100 is a DELETE.
    Returns (schema, batches, row kinds per batch)."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import parse_type_string
    from paimon_tpu_torch.types import RowKind

    rng = np.random.default_rng(seed)
    plain_types = {c: PU_TYPES[i % 4] for i, c in enumerate(PU_PLAIN)}
    builder = Schema.builder().column("id", parse_type_string(
        "BIGINT NOT NULL")).column("g", parse_type_string("BIGINT"))
    for c in PU_MEMBERS:
        builder = builder.column(c, parse_type_string("INT"))
    builder = builder.column("fsum", parse_type_string("DOUBLE")) \
        .column("cnt", parse_type_string("INT"))
    for c in PU_PLAIN:
        builder = builder.column(c, parse_type_string(plain_types[c]))
    schema = builder.primary_key("id").options({
        "bucket": "1", "write-only": "true",
        "parquet.enable.dictionary": "false",
        "merge-engine": "partial-update",
        "fields.g.sequence-group": ",".join(PU_MEMBERS),
        "fields.fsum.aggregate-function": "sum",
        "fields.cnt.aggregate-function": "count"}).build()
    arrow = {"BIGINT": pa.int64(), "DOUBLE": pa.float64(),
             "INT": pa.int32(), "STRING": pa.string()}

    def values(t, n):
        if t == "STRING":
            return pa.array([f"s{v}" for v in rng.integers(0, 1000, n)])
        if t == "DOUBLE":
            return pa.array(rng.standard_normal(n))
        return pa.array(rng.integers(-1000, 1000, n), arrow[t])

    batches, kinds = [], []
    for j in range(commits):
        ids = rng.permutation(keys)
        own = {PU_PLAIN[(14 * j + i) % 52] for i in range(14)}
        cols = {"id": pa.array(ids, pa.int64()),
                "g": pa.array(rng.integers(0, 1000, keys), pa.int64())}
        for c in PU_MEMBERS:
            cols[c] = values("INT", keys)
        cols["fsum"] = values("DOUBLE", keys)
        cols["cnt"] = values("INT", keys)
        for c in PU_PLAIN:
            cols[c] = values(plain_types[c], keys) if c in own \
                else pa.nulls(keys, arrow[plain_types[c]])
        batches.append(pa.table(cols))
        kinds.append(np.where(rng.random(keys) < 0.01, RowKind.DELETE,
                              RowKind.INSERT).astype(np.int8))
    return schema, batches, kinds


def same_tables(what: str, got, want, approx=(), rtol: float = 0.0) -> None:
    """Exactly equal tables, except the `approx` float columns, equal
    within `rtol` with the same nulls."""
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: shape or columns differ")
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        if name not in approx:
            if not g.equals(w):
                raise AssertionError(f"{what}: column {name} differs")
            continue
        gv = g.to_numpy(zero_copy_only=False)
        wv = w.to_numpy(zero_copy_only=False)
        if not (np.array_equal(np.isnan(gv), np.isnan(wv))
                and np.allclose(gv, wv, rtol=rtol, atol=0.0,
                                equal_nan=True)):
            raise AssertionError(f"{what}: column {name} beyond rtol {rtol}")


# BASELINE config 5 (changelog-producer=lookup): the bucket's state, its
# streaming commits and the share of commits that update a live id
C5_KEYS = 10_000_000
C5_COMMITS = 20
C5_PER_COMMIT = 1_000_000        # one 5 s checkpoint at 200k rows/s
C5_UPDATE_SHARE = 0.9
C5_VALUE_COLS = ("v1", "v2", "v3")


def rss_gib() -> float:
    """The host's resident set of this process, GiB (/proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


class ChangelogTimer:
    """Where the compaction changelog producers spend their time.

    For as long as it is entered it wraps, from this script, the
    manager's producer (MergeTreeCompactManager._produce_changelog), the
    merges made while a producer runs (_merge_tables: the lookup
    replay's state merges), the diff as the manager calls it
    (keyed_changelog_diff) and the diff's two key-rank parts in
    ops/diff.py: _encode_lanes (host lane encode) and _device_ranks
    (upload, sort, the kernel, running count), each between two
    synchronisations of the card.  The diff's Arrow take, value compare
    and concatenation are its time less those two.  At the end of each
    producer run, while the compaction's file memo is still held, it
    samples the host's resident set."""

    FIELDS = ("producer", "state_merge", "diff", "encode", "ranks")

    def __init__(self):
        self.s = {f: 0.0 for f in self.FIELDS}
        self.calls = {f: 0 for f in self.FIELDS}
        self.rss_max_gib = 0.0
        self._in_producer = False

    def snapshot(self) -> dict:
        out = {f"{f}_s": v for f, v in self.s.items()}
        out.update({f"{f}_calls": v for f, v in self.calls.items()})
        return out

    def delta(self, before: dict) -> dict:
        now = self.snapshot()
        out = {k: now[k] - before[k] for k in now}
        out["arrow_s"] = out["diff_s"] - out["encode_s"] - out["ranks_s"]
        return out

    def _timed(self, field: str, fn, only_in_producer: bool = False):
        import torch

        def call(*args, **kwargs):
            if only_in_producer and not self._in_producer:
                return fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if field == "producer":
                self._in_producer = True
            try:
                out = fn(*args, **kwargs)
            finally:
                if field == "producer":
                    self._in_producer = False
                    self.rss_max_gib = max(self.rss_max_gib, rss_gib())
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.s[field] += time.perf_counter() - t0
            self.calls[field] += 1
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.compact import manager
        from paimon_tpu_torch.ops import diff
        mgr = manager.MergeTreeCompactManager
        self._saved = []
        for owner, attr, field, only in (
                (manager, "keyed_changelog_diff", "diff", False),
                (diff, "_encode_lanes", "encode", False),
                (diff, "_device_ranks", "ranks", False),
                (mgr, "_produce_changelog", "producer", False),
                (mgr, "_merge_tables", "state_merge", True)):
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(field, fn, only))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def bigint_schema(options):
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v1", BigIntType()).column("v2", DoubleType())
            .column("v3", IntType()).primary_key("id")
            .options(options).build())


def random_values(rng, n: int) -> dict:
    """bench.py's value columns: v1 BIGINT, v2 DOUBLE, v3 INT."""
    return {"v1": rng.integers(0, 1 << 40, n),
            "v2": rng.random(n),
            "v3": rng.integers(0, 100, n).astype(np.int32)}


def value_table(ids: np.ndarray, vals: dict):
    import pyarrow as pa
    return pa.table({"id": pa.array(ids, pa.int64()),
                     "v1": pa.array(vals["v1"], pa.int64()),
                     "v2": pa.array(vals["v2"], pa.float64()),
                     "v3": pa.array(vals["v3"], pa.int32())})


class DenseState:
    """The visible rows of a table whose ids are dense non-negative
    integers, held in tensors on `dev` (the card in the run): the oracle
    of the changelog and the fold of a consumer's stream.  Every
    operation is a sort, scatter or gather there, so the oracle's work
    stays off the host between the phase's steps."""

    def __init__(self, capacity: int, dev):
        import torch
        self.dev = dev
        self.live = torch.zeros(capacity, dtype=torch.bool, device=dev)
        self.cols = {"v1": torch.zeros(capacity, dtype=torch.int64,
                                       device=dev),
                     "v2": torch.zeros(capacity, dtype=torch.float64,
                                       device=dev),
                     "v3": torch.zeros(capacity, dtype=torch.int32,
                                       device=dev)}

    def transitions(self, ids, vals: dict) -> dict:
        """Apply one commit of upserts (tensors; the last value of an id
        in the commit wins) and return the changelog it implies: +I for
        an id that was not live, -U with the old row then +U with the
        new one for a changed value, nothing for an unchanged one."""
        import torch
        order = torch.sort(ids, stable=True).indices
        s = ids[order]
        ends = torch.ones(len(s), dtype=torch.bool, device=self.dev)
        ends[:-1] = s[1:] != s[:-1]
        last = order[ends]
        u = ids[last]
        new = {c: v[last] for c, v in vals.items()}
        was = self.live[u]
        diff = torch.zeros_like(was)
        for c in C5_VALUE_COLS:
            diff |= self.cols[c][u] != new[c]
        changed = was & diff
        ins, upd = ~was, u[changed]
        n_ins, n_upd = int(ins.sum()), len(upd)
        kind = torch.cat([torch.full((n_ins,), k, dtype=torch.int8,
                                     device=self.dev)
                          for k in (0,)] +
                         [torch.full((n_upd,), k, dtype=torch.int8,
                                     device=self.dev) for k in (1, 2)])
        out = {"id": torch.cat([u[ins], upd, upd]), "kind": kind}
        for c in C5_VALUE_COLS:
            out[c] = torch.cat([new[c][ins], self.cols[c][upd],
                                new[c][changed]])
        self.live[u] = True
        for c in C5_VALUE_COLS:
            self.cols[c][u] = new[c]
        return out

    def fold(self, rows: dict) -> None:
        """Apply changelog rows in their order: an id's last row decides
        (+I/+U sets the row, -U/-D removes it); the last row of each id
        is found by a scatter of row numbers by id."""
        import torch
        ids = rows["id"]
        at = torch.full((len(self.live),), -1, dtype=torch.int64,
                        device=self.dev)
        at.scatter_reduce_(0, ids, torch.arange(len(ids), device=self.dev),
                           reduce="amax")
        u = torch.nonzero(at >= 0).flatten()
        last = at[u]
        kinds = rows["kind"][last]
        keep = (kinds == 0) | (kinds == 2)
        self.live[u[~keep]] = False
        self.live[u[keep]] = True
        for c in C5_VALUE_COLS:
            self.cols[c][u[keep]] = rows[c][last][keep]

    def rows(self) -> dict:
        import torch
        ids = torch.nonzero(self.live).flatten()
        return {"id": ids, **{c: v[ids] for c, v in self.cols.items()}}


def arrow_rows(t, dev) -> dict:
    """Column tensors on `dev` of a stream read: id, the values, kind,
    sequence."""
    import torch

    from paimon_tpu_torch.core.read import ROW_KIND_COL
    from paimon_tpu_torch.ops.merge import SEQ_COL
    cols = {c: t.column(c) for c in ("id",) + C5_VALUE_COLS}
    cols["kind"] = t.column(ROW_KIND_COL)
    cols["seq"] = t.column(SEQ_COL)
    return {c: torch.from_numpy(np.array(col.combine_chunks().to_numpy()))
            .to(dev) for c, col in cols.items()}


def canonical_order(rows: dict):
    """The rows' order by (id, kind, v1, v2, v3): stable sorts from the
    least significant column to the most."""
    import torch
    order = torch.arange(len(rows["id"]), device=rows["id"].device)
    for c in reversed(("id", "kind") + C5_VALUE_COLS):
        order = order[torch.sort(rows[c][order], stable=True).indices]
    return order


def same_multiset(what: str, got: dict, want: dict) -> None:
    """Equal rows (kind, id, values) counted with multiplicity: equal
    columns in one canonical order of each side."""
    import torch
    if len(got["id"]) != len(want["id"]):
        raise AssertionError(f"{what}: {len(got['id'])} changelog rows, "
                             f"oracle {len(want['id'])}")
    og, ow = canonical_order(got), canonical_order(want)
    for c in ("kind", "id") + C5_VALUE_COLS:
        if not torch.equal(got[c][og], want[c][ow]):
            raise AssertionError(f"{what}: column {c} differs from the "
                                 f"oracle")


def check_adjacent_updates(what: str, rows: dict) -> None:
    """Every -U directly followed by the +U of the same id, and no +U
    without its -U."""
    kinds, ids = rows["kind"], rows["id"]
    ub = (kinds == 1).nonzero().flatten()
    nxt = ub + 1
    if len(ub) and int(nxt.max()) >= len(kinds) or \
            not bool((kinds[nxt] == 2).all()) or \
            not bool((ids[nxt] == ids[ub]).all()) or \
            int((kinds == 2).sum()) != len(ub):
        raise AssertionError(f"{what}: a -U is not directly followed by "
                             f"its +U")


def latency_stats(seconds: list, commits: list) -> dict:
    """p50 and max of the changelog latencies, in seconds and in commits
    (None where no commit's changelog arrived within the loop)."""
    out = {}
    for unit, values in (("s", seconds), ("commits", commits)):
        out[f"latency_{unit}_p50"] = \
            float(np.percentile(values, 50)) if values else None
        out[f"latency_{unit}_max"] = max(values) if values else None
    return out


def changelog_lookup_upsert(work: str, rec: Recorder, timer: ChangelogTimer,
                            keys: int = C5_KEYS, commits: int = C5_COMMITS,
                            per_commit: int = C5_PER_COMMIT,
                            device=None) -> dict:
    """BASELINE config 5 at full size: a `keys`-row bucket (ids 0 ..
    keys-1) written as one commit and fully compacted (the first
    changelog: every row +I), a consumer on the default startup mode
    (latest-full) with a consumer id, then `commits` streaming commits
    of `per_commit` upserts (each an update of a live id with
    probability C5_UPDATE_SHARE, else a new id; values from seed 7)
    with inline compaction, the consumer polling after each until it is
    caught up.  Every poll's changelog is held against a numpy oracle of
    the state transitions, the folded stream against the batch read,
    and a restored consumer must find nothing new.  Returns the
    config's metrics."""
    import torch

    from paimon_tpu_torch.table import FileStoreTable

    name = "changelog_lookup_upsert"
    table = FileStoreTable.create(os.path.join(work, name), bigint_schema({
        "bucket": "1", "parquet.enable.dictionary": "false",
        "changelog-producer": "lookup"}), device=device)
    dev = table.device
    capture = rec.capture
    rng = np.random.default_rng(7)
    capacity = keys + commits * per_commit
    oracle = DenseState(capacity, dev)

    def on_dev(ids, vals):
        import torch
        return (torch.from_numpy(ids).to(dev),
                {c: torch.from_numpy(v).to(dev) for c, v in vals.items()})

    ids = np.arange(keys, dtype=np.int64)
    vals = random_values(rng, keys)
    oracle.transitions(*on_dev(ids, vals))

    def write_state():
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(value_table(ids, vals))
            wb.new_commit().commit(w.prepare_commit())

    rec.run(name, "state write", keys, dev, write_state)
    t_before = timer.snapshot()
    if rec.run(name, "state full compaction", keys, dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: the full compaction committed "
                             f"nothing")
    state_split = timer.delta(t_before)
    first_cl = table.latest_snapshot().changelog_record_count
    if first_cl != keys:
        raise AssertionError(f"{name}: the first changelog holds "
                             f"{first_cl} rows, expected {keys} +I")
    del ids, vals

    consumer = table.copy({"consumer-id": "config5",
                           "table-read.sequence-number.enabled": "true"})
    rb = consumer.new_read_builder()
    scan, read = rb.new_stream_scan(), rb.new_read()
    first = arrow_rows(rec.run(name, "stream first plan (latest-full)",
                               keys, dev, lambda: read.to_arrow(scan.plan())),
                       dev)
    scan.notify_checkpoint_complete(scan.checkpoint())
    want = oracle.rows()
    order = torch.sort(first["id"], stable=True).indices
    if bool((first["kind"] != 0).any()) or not all(
            torch.equal(first[c][order], want[c])
            for c in ("id",) + C5_VALUE_COLS):
        raise AssertionError(f"{name}: the first plan is not the state "
                             f"as +I")
    fold = DenseState(capacity, dev)
    fold.fold(first)
    del first, want, order

    seq0 = keys                      # the first streaming row's sequence
    expected: dict = {}
    commit_done: dict = {}
    delivered: dict = {}             # commit -> (poll time, at commit)
    stats = {"cycle_s": [], "poll_s": 0.0, "poll_rows": 0, "polls": 0,
             "changelog_snapshots": 0}

    def poll(at: int) -> None:
        """Poll until caught up; check each plan's changelog and fold
        it into the consumer's state."""
        while True:
            t0 = time.perf_counter()
            plan = scan.plan()
            if plan is None:
                stats["poll_s"] += time.perf_counter() - t0
                return
            got = read.to_arrow(plan)
            scan.notify_checkpoint_complete(scan.checkpoint())
            t1 = time.perf_counter()
            stats["poll_s"] += t1 - t0
            stats["polls"] += 1
            stats["poll_rows"] += got.num_rows
            if not got.num_rows:
                continue
            rows = arrow_rows(got, dev)
            stats["changelog_snapshots"] += 1
            newer = (rows["kind"] == 0) | (rows["kind"] == 2)
            commit_of = (rows["seq"][newer] - seq0) // per_commit + 1
            covered = torch.unique(commit_of).tolist()
            what = f"{name} snapshot {plan.snapshot_id}"
            if not covered or covered[0] < 1 or covered[-1] > at or \
                    any(c in delivered for c in covered):
                raise AssertionError(f"{what}: changelog of commits "
                                     f"{covered} at commit {at}")
            want = [expected.pop(c) for c in covered]
            same_multiset(what, rows, {c: torch.cat([w[c] for w in want])
                                       for c in want[0]})
            check_adjacent_updates(what, rows)
            for c in covered:
                delivered[int(c)] = (t1, at)
            fold.fold(rows)

    writer_builder = table.new_stream_write_builder() \
        .with_commit_user("config5")
    writer, committer = writer_builder.new_write(), writer_builder.new_commit()
    live = keys
    launches_before = rec.counts()
    t_before = timer.snapshot()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    capture.where = f"{name} upsert"
    try:
        for k in range(1, commits + 1):
            update = rng.random(per_commit) < C5_UPDATE_SHARE
            ids = np.empty(per_commit, dtype=np.int64)
            ids[update] = rng.integers(0, live, int(update.sum()))
            fresh = per_commit - int(update.sum())
            ids[~update] = live + np.arange(fresh)
            live += fresh
            vals = random_values(rng, per_commit)
            expected[k] = oracle.transitions(*on_dev(ids, vals))
            batch = value_table(ids, vals)
            copied = capture.seconds
            t0 = time.perf_counter()
            writer.write_arrow(batch)
            committer.commit(writer.prepare_commit(), commit_identifier=k)
            commit_done[k] = time.perf_counter()
            stats["cycle_s"].append(commit_done[k] - t0
                                    - (capture.seconds - copied))
            poll(k)
    finally:
        writer.close()
    upsert_split = timer.delta(t_before)
    launches = tuple(a - b for a, b in zip(rec.counts(), launches_before))
    upserts = commits * per_commit
    upsert_s = float(sum(stats["cycle_s"]))
    rec.add(name, f"upsert ({commits} streaming commits, inline "
            f"compaction)", upserts, dev, upsert_s, launches,
            **{f"changelog_{k}": v for k, v in upsert_split.items()})
    rec.add(name, "stream read (changelog polls)", stats["poll_rows"], dev,
            stats["poll_s"], (0, 0))

    lat_s = [delivered[k][0] - commit_done[k] for k in sorted(delivered)]
    lat_commits = [delivered[k][1] - k for k in sorted(delivered)]
    pending = [k for k in range(1, commits + 1) if k not in delivered]
    # the commits still in L0 get their changelog from one more full
    # compaction (outside the latency figures)
    rec.run(name, "final full compaction", live, dev,
            lambda: table.compact(full=True))
    poll(commits)
    if expected:
        raise AssertionError(f"{name}: no changelog for commits "
                             f"{sorted(expected)}")
    batch_read = table.to_arrow()
    want = fold.rows()
    got = {c: torch.from_numpy(np.ascontiguousarray(
               batch_read.column(c).combine_chunks().to_numpy())).to(dev)
           for c in ("id",) + C5_VALUE_COLS}
    order = torch.sort(got["id"], stable=True).indices
    if batch_read.num_rows != len(want["id"]) or not all(
            torch.equal(got[c][order], want[c])
            for c in ("id",) + C5_VALUE_COLS):
        raise AssertionError(f"{name}: the folded stream differs from the "
                             f"batch read")
    del got, order
    if not all(torch.equal(want[c], v) for c, v in oracle.rows().items()):
        raise AssertionError(f"{name}: the folded stream differs from the "
                             f"oracle")
    restored = rb.new_stream_scan()
    restored.restore(scan.checkpoint())
    if restored.plan() is not None or rb.new_stream_scan().plan() \
            is not None:
        raise AssertionError(f"{name}: a restored consumer found new rows")
    out = {
        "keys": keys, "commits": commits, "rows_per_commit": per_commit,
        "upsert_rows_per_s": upserts / upsert_s,
        "upsert_s": upsert_s, "cycle_s": stats["cycle_s"],
        **latency_stats(lat_s, lat_commits),
        "delivered_in_loop": len(lat_s), "pending_at_end": pending,
        "stream_read_rows_per_s": stats["poll_rows"] / stats["poll_s"],
        "stream_read_rows": stats["poll_rows"], "polls": stats["polls"],
        "changelog_snapshots": stats["changelog_snapshots"],
        "state_compaction_split": state_split,
        "upsert_split": upsert_split,
        "host_rss_max_gib": timer.rss_max_gib,
        "live_keys_at_end": len(want["id"])}
    latency = (f"p50 {out['latency_s_p50']:.2f} s / "
               f"{out['latency_commits_p50']:.1f} commits, max "
               f"{out['latency_s_max']:.2f} s / "
               f"{out['latency_commits_max']} commits" if lat_s
               else "none within the loop")
    log(f"  {name}: {upserts / upsert_s:,.0f} upsert rows/s over "
        f"{commits} commits; changelog latency {latency} ({len(pending)} "
        f"commits pending at the end); stream read "
        f"{out['stream_read_rows_per_s']:,.0f} rows/s; diffs "
        f"{upsert_split['diff_s']:.2f} s = encode "
        f"{upsert_split['encode_s']:.2f} + device ranks "
        f"{upsert_split['ranks_s']:.2f} + Arrow "
        f"{upsert_split['arrow_s']:.2f}; state merges "
        f"{upsert_split['state_merge_s']:.2f} s; host RSS max "
        f"{timer.rss_max_gib:.2f} GiB; checks passed")
    table.file_io.delete(table.path, recursive=True)
    return out


def check_joint_ranks(n: int = 1 << 19, seed: int = 23) -> dict:
    """The diff's key ranks on the card against their plain numpy
    version (np.unique over the lanes, the reference's computation) on
    the host, on three tables shaped like a lookup replay's before,
    after and delta (key-sorted BIGINT ids, n rows in all): equal
    exactly, and both timed on the host clock."""
    import pyarrow as pa

    from paimon_tpu_torch.ops import diff
    from paimon_tpu_torch.ops.normkey import NormalizedKeyEncoder

    rng = np.random.default_rng(seed)
    state = np.sort(rng.choice(4 * n, n * 9 // 20, replace=False))
    delta = np.sort(rng.choice(4 * n, n // 10, replace=False))
    tables = [pa.table({"_KEY_id": pa.array(k, pa.int64())})
              for k in (state, np.union1d(state, delta), delta)]
    enc = NormalizedKeyEncoder([pa.int64()], nullable=[False])
    rows = sum(t.num_rows for t in tables)
    diff.joint_key_ranks(tables, ["_KEY_id"], enc)          # warm
    t0 = time.perf_counter()
    got = diff.joint_key_ranks(tables, ["_KEY_id"], enc)
    t1 = time.perf_counter()
    want = diff.joint_key_ranks_plain(tables, ["_KEY_id"], enc)
    t2 = time.perf_counter()
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("joint key ranks: card != np.unique")
    out = {"rows": rows, "card_s": t1 - t0, "plain_host_s": t2 - t1}
    log(f"joint key ranks of {rows} rows: card == np.unique; card "
        f"{out['card_s']:.3f} s (encode, upload, sort, kernel, download), "
        f"np.unique on the host {out['plain_host_s']:.3f} s")
    return out


def changelog_files(table) -> dict:
    """{snapshot id: [each changelog file's rows as Arrow, in manifest
    order]}, read with pyarrow alone."""
    import pyarrow.parquet as pq
    scan = table.new_scan()
    out = {}
    for snap in table.snapshot_manager.snapshots():
        files = [pq.read_table(scan.path_factory.data_file_path(
                     s.partition, s.bucket, f.file_name))
                 for s in scan.plan_changelog(snap).splits
                 for f in s.data_files]
        if files:
            out[snap.id] = files
    return out


def coverage_producer(path: str, producer: str, device,
                      keys: int = COVERAGE_KEYS, commits: int = 5,
                      seed: int = 7):
    """One producer at coverage size: `commits` streaming commits (inline
    compaction on), each every key in a random order with random values
    and 1 row in 100 a DELETE, then a full compaction.  Returns (the
    changelog files by snapshot, the batch read)."""
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import RowKind

    table = FileStoreTable.create(path, bigint_schema({
        "bucket": "1", "parquet.enable.dictionary": "false",
        "changelog-producer": producer}), device=device)
    rng = np.random.default_rng(seed)
    wb = table.new_stream_write_builder().with_commit_user("coverage")
    with wb.new_write() as w:
        c = wb.new_commit()
        for k in range(1, commits + 1):
            kinds = np.where(rng.random(keys) < 0.01, RowKind.DELETE,
                             RowKind.INSERT).astype(np.int8)
            w.write_arrow(value_table(rng.permutation(keys),
                                      random_values(rng, keys)), kinds)
            c.commit(w.prepare_commit(), commit_identifier=k)
    table.compact(full=True)
    return changelog_files(table), table.to_arrow()


def changelog_producers_coverage(work: str, rec: Recorder) -> None:
    """input, lookup and full-compaction on the card, each held against
    the same table run by the port on the CPU: the changelog files of
    every snapshot, file for file and row for row, and the batch read."""
    import torch

    name = "changelog_producers_coverage"
    for producer in ("input", "lookup", "full-compaction"):
        card = rec.run(name, producer, 5 * COVERAGE_KEYS,
                       torch.device("cuda"),
                       lambda: coverage_producer(
                           os.path.join(work, f"cov-{producer}-card"),
                           producer, None))
        cpu = coverage_producer(os.path.join(work, f"cov-{producer}-cpu"),
                                producer, "cpu")
        what = f"{name} {producer}"
        if not card[0] or sorted(card[0]) != sorted(cpu[0]):
            raise AssertionError(f"{what}: changelog snapshots "
                                 f"{sorted(card[0])} vs cpu "
                                 f"{sorted(cpu[0])}")
        for sid in card[0]:
            a, b = card[0][sid], cpu[0][sid]
            if len(a) != len(b) or not all(x.equals(y)
                                           for x, y in zip(a, b)):
                raise AssertionError(f"{what}: the changelog of snapshot "
                                     f"{sid} differs from the cpu run")
        if not card[1].equals(cpu[1]):
            raise AssertionError(f"{what}: the batch read differs from the "
                                 f"cpu run")
        rows = sum(t.num_rows for f in card[0].values() for t in f)
        log(f"  {what}: card == cpu: {len(card[0])} changelog snapshots, "
            f"{rows} changelog rows, batch read of {card[1].num_rows} rows")
        for d in ("card", "cpu"):
            shutil.rmtree(os.path.join(work, f"cov-{producer}-{d}"),
                          ignore_errors=True)


MESH_ROWS = 625_000              # cut from 10M, then 5M, 2.5M, 1.25M
                                 # (script time)
MESH_LANES = 8


class OvcTimer:
    """Host seconds in the run-code offsets (ops.ovc.run_ovc_offsets)
    while entered: the mesh engine computes them on the host for every
    lane of every window."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        from paimon_tpu_torch.ops import ovc
        self._ovc = ovc
        self._fn = fn = ovc.run_ovc_offsets

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        ovc.run_ovc_offsets = timed
        return self

    def __exit__(self, *exc):
        self._ovc.run_ovc_offsets = self._fn


def check_sums(what: str, got, ids: np.ndarray, vals: np.ndarray) -> None:
    """Per-id sums of v: ids exact, sums within rtol 1e-12 of numpy's
    (the engine adds in sequence order, numpy in id-sorted order)."""
    import pyarrow.compute as pc
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    if got.num_rows != len(starts) or not np.array_equal(
            got.column("id").to_numpy(), s[starts]):
        raise AssertionError(f"{what}: ids differ from the oracle")
    if not np.allclose(got.column("v").to_numpy(),
                       np.add.reduceat(vals[order], starts),
                       rtol=1e-12, atol=0.0):
        raise AssertionError(f"{what}: sums beyond rtol 1e-12 of numpy's")


def check_rescaled(what: str, table, buckets: int) -> None:
    """Every row of every split in the bucket that the reference's
    formula (core/bucket._bucket_from_hash) gives its key."""
    from paimon_tpu_torch.core.bucket import KeyHasher, _bucket_from_hash

    hasher = KeyHasher(["id"], [table.schema.logical_row_type()
                                .get_field("id").type])
    read = table.new_read_builder().new_read()
    for split in table.new_scan().plan().splits:
        rows = read.read_split(split)
        h = (hasher.hashes(rows) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if not (_bucket_from_hash(h, buckets) == split.bucket).all():
            raise AssertionError(f"{what}: a row of bucket {split.bucket} "
                                 f"belongs elsewhere")


def mesh_compaction(work: str, rec: Recorder, rows: int = MESH_ROWS,
                    device="cuda") -> dict:
    """parallel/dryrun.run_engines on the card: deduplicate and
    aggregation (v sum) tables of >= `rows` input rows, MESH_LANES
    buckets, compacted by compact_table_mesh on MESH_LANES lanes of one
    card (one batched merge a window step); each read held against a
    numpy oracle, the engine's retries, fallbacks and cleanup errors 0,
    the offset-value-code variant launched with MESH_LANES lanes in one
    launch; then the deduplicate table rescaled to twice the buckets,
    read back equal, every row in its formula's bucket, the schema's
    bucket option updated and no row dropped by the dispatch."""
    from paimon_tpu_torch.metrics import COMPACTION_WINDOW_MS, global_registry
    from paimon_tpu_torch.parallel import (
        bucket_mesh, compact_table_mesh, rescale, rescale_table_buckets,
    )
    from paimon_tpu_torch.parallel.dryrun import engine_table, input_rows
    from paimon_tpu_torch.table import FileStoreTable

    mesh = bucket_mesh(MESH_LANES, device=device)
    window_ms = global_registry().compaction_metrics().histogram(
        COMPACTION_WINDOW_MS)
    out = {"lanes": MESH_LANES, "device": str(mesh.device)}
    for engine in ("deduplicate", "aggregation"):
        name = f"mesh_{engine}"
        path = os.path.join(work, name)
        # the table of parallel/dryrun.run_engines, with every row
        # written kept for the oracles
        built = []
        rec.run(name, "write", lambda: len(built[0][1]), mesh.device,
                lambda: built.append(engine_table(path, engine, MESH_LANES,
                                                  rows, device)))
        table, ids, vals = built[0]
        if engine == "deduplicate":
            win = last_writer_oracle(ids)

            def check(what, got):
                check_rows(what, got, {"id": ids, "v": vals}, win, "id")
        else:
            def check(what, got):
                check_sums(what, got, ids, vals)
        n_in = input_rows(table)
        w0, timer = window_ms.total_sum, OvcTimer()
        with timer:
            stats = rec.run(name, "compact", n_in, table.device,
                            lambda: compact_table_mesh(table, mesh))
        compact_s, compact_gib = (rec.phases[-1]["s"],
                                  rec.phases[-1]["peak_gib"])
        if stats.snapshot_id is None or stats.retries or stats.fallbacks \
                or stats.cleanup_errors:
            raise AssertionError(f"{name}: snapshot {stats.snapshot_id}, "
                                 f"{stats.retries} retries, "
                                 f"{stats.fallbacks} fallbacks, "
                                 f"{stats.cleanup_errors} cleanup errors")
        got = rec.run(name, "read", n_in, table.device, table.to_arrow)
        check(f"{name} read after mesh compaction", got)
        if stats.output_rows != got.num_rows:
            raise AssertionError(f"{name}: {stats.output_rows} output rows, "
                                 f"{got.num_rows} read")
        batched = sorted((k[5], k[3] // k[5], k[2], k[1], n)
                         for k, n in rec.capture.calls.items()
                         if k[0] == name and k[5] > 1)
        if not any(b == MESH_LANES and v == "ovc"
                   for b, _, _, v, _ in batched):
            raise AssertionError(f"{name}: no offset-value-code launch of "
                                 f"{MESH_LANES} lanes ({batched})")
        res = {"input_rows": n_in, "output_rows": stats.output_rows,
               "commits": len(ids) // (rows // 2), "compact_s": compact_s,
               "rows_per_s": n_in / compact_s, "windows": stats.windows,
               "peak_window_rows": stats.peak_window_rows,
               "peak_buffered_rows": stats.peak_buffered_rows,
               "skew": stats.skew, "lane_rows": stats.lane_rows,
               "window_s": (window_ms.total_sum - w0) / 1e3,
               "ovc_host_s": timer.seconds, "ovc_calls": timer.calls,
               "peak_gib": compact_gib,
               "batched_launches": [
                   {"b": b, "n": n, "lanes": la, "variant": v,
                    "launches": c} for b, n, la, v, c in batched]}
        if engine == "deduplicate":
            dispatches = []
            kernel = rescale._dispatch_kernel

            def recorded(*args, **kwargs):
                blocks, dropped = kernel(*args, **kwargs)
                dispatches.append({"cap": args[4], "dropped": dropped})
                return blocks, dropped
            rescale._dispatch_kernel = recorded
            try:
                sid = rec.run(name, "rescale", got.num_rows, table.device,
                              lambda: rescale_table_buckets(
                                  table, 2 * MESH_LANES, mesh))
            finally:
                rescale._dispatch_kernel = kernel
            again = FileStoreTable.load(path, device=device)
            if sid is None or again.options.bucket != 2 * MESH_LANES or \
                    not dispatches or dispatches[-1]["dropped"]:
                raise AssertionError(f"{name} rescale: snapshot {sid}, "
                                     f"bucket {again.options.bucket}, "
                                     f"dispatches {dispatches}")
            check(f"{name} read after rescale", rec.run(
                name, "read rescaled", got.num_rows, table.device,
                again.to_arrow))
            check_rescaled(f"{name} rescale", again, 2 * MESH_LANES)
            res["rescale"] = {"rows": got.num_rows,
                              "s": rec.phases[-2]["s"],
                              "rows_per_s": rec.phases[-2]["rows_per_s"],
                              "peak_gib": rec.phases[-2]["peak_gib"],
                              "buckets": 2 * MESH_LANES,
                              "dispatches": dispatches}
        out[engine] = res
        log(f"  {name}: {json.dumps(res)}")
        shutil.rmtree(path, ignore_errors=True)
    return out


# -- primary-key tables in the bucket modes users create by default --------

BM_TARGET = 2_000_000            # dynamic-bucket.target-row-num's default
# dyn_dedup runs at a sixth of the size it was first run at (for the
# script's time; below 2M distinct ids it would fill one bucket only),
# xpart_upsert at an eighth
DYN_ROWS = 3_500_000             # dyn_dedup_3.5M: 7 commits of 500K (10
DYN_KEYS = 4_000_000             # until the stream phase came), ids
DYN_COMMITS = 7                  # uniform in [0, 4M): 2.33M distinct
DYN_FRESH = 125_000              # upserts of existing ids, a fresh table
DYN_EVOLVED = 250_000            # upserts a commit under the new schema
#                                  (500K and 1M until the SQL phase came,
#                                  250K and 500K until the search phase)
XPART_KEYS = 125_000             # xpart_upsert_125K: 4 commits of 31.25K
XPART_UPSERTS = 15_625           # keys, then 4 commits of 15.625K upserts
                                 # (250K keys, 31.25K upserts until search)
#                                  (2M and 250K until the formats phase
#                                  came, 1M and 125K until the SQL phase,
#                                  500K and 62.5K until the stream phase)
XPART_PARTS = 4
POSTPONE_ROWS = 500_000          # postpone_500K: 4 commits of 125K (8M
                                 # until the append phase came, 4M until
                                 # the SQL phase, 2M until the stream
                                 # phase)
POSTPONE_TARGET = 5_000_000      # postpone.target-row-num-per-bucket


class Clock:
    """Host seconds of a table's steps outside its recorded phases (data
    and oracles, checks), summed into `out[key]`."""

    def __init__(self, out: dict):
        self.out = out

    def __call__(self, key: str, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        self.out[key] = self.out.get(key, 0.0) + time.perf_counter() - t0
        return res


def bucket_ids(table) -> tuple:
    """(ids, bucket of each) of every live row, read split by split."""
    rb = table.new_read_builder().with_projection(["id"])
    read = rb.new_read()
    ids, buckets = [], []
    for split in rb.new_scan().plan().splits:
        got = read.read_split(split).column("id").to_numpy()
        ids.append(got)
        buckets.append(np.full(len(got), split.bucket, np.int32))
    ids, buckets = np.concatenate(ids), np.concatenate(buckets)
    order = np.argsort(ids, kind="stable")
    return ids[order], buckets[order]


def distinct(x: np.ndarray) -> np.ndarray:
    """Sorted distinct values (np.unique without its return arrays,
    which numpy 2.3 runs through a hash table 40x slower than a sort at
    ten million int32 values on the H100 machine's host)."""
    s = np.sort(x)
    return s[np.r_[True, s[1:] != s[:-1]]] if len(s) else s


def check_hash_index(what: str, table, ids, buckets, target: int) -> dict:
    """The dynamic-bucket hash index against the rows: each id in
    exactly one bucket, whose index file holds the distinct hashes of
    that bucket's ids and no other; every bucket but the last full at
    `target` hashes, the last at most that; the files' total the
    distinct 32-bit hashes of the live ids."""
    import pyarrow as pa

    from paimon_tpu_torch.core.bucket import KeyHasher
    from paimon_tpu_torch.core.dynamic_bucket import (
        as_int32, hash_index_entries,
    )
    from paimon_tpu_torch.types import BigIntType

    if len(ids) > 1 and not (ids[1:] > ids[:-1]).all():
        raise AssertionError(f"{what}: an id lives in two buckets")
    scan = table.new_scan()
    entries = sorted(hash_index_entries(
        scan, table.snapshot_manager.latest_snapshot()),
        key=lambda e: e.bucket)
    counts = [e.index_file.row_count for e in entries]
    if [e.bucket for e in entries] != list(range(len(entries))) or \
            any(c != target for c in counts[:-1]) or counts[-1] > target:
        raise AssertionError(f"{what}: index buckets "
                             f"{[(e.bucket, c) for e, c in zip(entries, counts)]}")
    hashes = as_int32(KeyHasher(["id"], [BigIntType(False)]).hashes(
        pa.table({"id": pa.array(ids, pa.int64())})))
    if sum(counts) != len(distinct(hashes)):
        raise AssertionError(f"{what}: {sum(counts)} hashes indexed, "
                             f"{len(distinct(hashes))} distinct")
    for e in entries:
        data = table.file_io.read_bytes(
            scan.path_factory.index_file_path(e.index_file.file_name))
        listed = np.sort(np.frombuffer(data, ">i4").astype(np.int32))
        if not np.array_equal(distinct(hashes[buckets == e.bucket]),
                              listed):
            raise AssertionError(f"{what}: bucket {e.bucket}'s index file "
                                 f"differs from its rows' hashes")
    return {"buckets": len(entries), "hashes": counts}


def check_evolved(what: str, got, cols: dict, win: np.ndarray,
                  old: np.ndarray) -> None:
    """The evolved schema's rows against the oracle: v2 renamed v2r, v3
    widened exactly, v4 null on the rows written before the evolution
    (`old`: per row of `cols`)."""
    import pyarrow.compute as pc
    check_rows(what, got.drop_columns(["v4"]).rename_columns(
        ["id", "v1", "v2", "v3"]), {k: cols[k] for k in
                                    ("id", "v1", "v2", "v3")}, win, "id")
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    v4 = got.column("v4").combine_chunks()
    nulls = np.asarray(v4.is_null())
    if got.column("v3").type != "int64" or \
            not np.array_equal(nulls, old[win]) or \
            not np.array_equal(v4.to_numpy(zero_copy_only=False)[~nulls],
                               cols["v4"][win][~nulls]):
        raise AssertionError(f"{what}: v3 or v4 differs from the oracle")


def dyn_dedup(work: str, rec: Recorder, device, scale: int) -> dict:
    """dyn_dedup_3.5M: Paimon's default bucket mode (no `bucket` option),
    deduplicate, write-only; 10 commits of uniform ids from one writer,
    a full compaction and a scan, the hash index
    held against the rows, a fresh table object's upserts of existing
    ids routed to their old buckets; then ADD COLUMN v4 DOUBLE, v3 INT
    -> BIGINT, RENAME v2 -> v2r, 2 commits of upserts under the new
    schema, a merge-on-read scan over runs of both schema ids, a full
    compaction and a scan."""
    import pyarrow as pa

    from paimon_tpu_torch.schema import SchemaChange
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType

    name = "dyn_dedup_3.5M"
    path = os.path.join(work, name)
    rows, keys = DYN_ROWS // scale, DYN_KEYS // scale
    target, per = BM_TARGET // scale, DYN_ROWS // scale // DYN_COMMITS
    opts = {"write-only": "true", "parquet.enable.dictionary": "false"}
    if target != BM_TARGET:
        opts["dynamic-bucket.target-row-num"] = str(target)
    out = {"rows": rows, "commits": DYN_COMMITS}
    clock = Clock(out)
    rng = np.random.default_rng(7)
    batches = clock("data_s", lambda: [
        value_table(rng.integers(0, keys, per), random_values(rng, per))
        for _ in range(DYN_COMMITS)])
    cols = clock("data_s", lambda: {
        c: np.concatenate([b.column(c).to_numpy() for b in batches])
        for c in ("id", "v1", "v2", "v3")})
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, bigint_schema(opts), device=device)
    dev = table.device

    def write():
        wb = table.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)
            out["assign_s"] = w._write.assign_seconds

    t0 = time.perf_counter()
    rec.run(name, "write", rows, dev, write)
    del batches
    if rec.run(name, "compact", rows, dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    clock("check_s", check_rows, f"{name} read after compaction",
          rec.run(name, "read", len(win), dev, table.to_arrow), cols, win,
          "id")
    ids, buckets = clock("bucket_ids_s", bucket_ids, table)
    out["index"] = clock("index_check_s", check_hash_index, name, table,
                         ids, buckets, target)

    # a fresh table object upserts existing ids: every one to its bucket
    fresh = value_table(rng.choice(ids, DYN_FRESH // scale, replace=False),
                        random_values(rng, DYN_FRESH // scale))
    index_before = table.latest_snapshot().index_manifest
    again = FileStoreTable.load(path, device=device)

    def upsert():
        wb = again.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(fresh)
            wb.new_commit().commit(w.prepare_commit())
            out["fresh_assign_s"] = w._write.assign_seconds

    rec.run(name, "fresh upsert", fresh.num_rows, dev, upsert)
    ids2, buckets2 = clock("bucket_ids_s", bucket_ids, again)
    if not (np.array_equal(ids, ids2) and np.array_equal(buckets, buckets2)
            and again.latest_snapshot().index_manifest == index_before):
        raise AssertionError(f"{name}: a fresh writer moved an existing "
                             f"id to another bucket")
    for c in cols:
        cols[c] = np.concatenate([cols[c], fresh.column(c).to_numpy()])
    out["before_evolution_s"] = time.perf_counter() - t0

    # schema evolution (Paimon docs, "Schema Evolution")
    t0 = time.perf_counter()
    again.schema_manager.commit_changes(
        SchemaChange.add_column("v4", DoubleType()),
        SchemaChange.update_column_type("v3", BigIntType()),
        SchemaChange.rename_column("v2", "v2r"))
    evolved = FileStoreTable.load(path, device=device)
    old = np.ones(len(cols["id"]), dtype=bool)
    cols["v3"] = cols["v3"].astype(np.int64)
    cols["v4"] = np.zeros(len(cols["id"]))
    new = []
    for _ in range(2):
        n = DYN_EVOLVED // scale
        vals = random_values(rng, n)
        new.append(pa.table({
            "id": pa.array(rng.integers(0, keys, n), pa.int64()),
            "v1": pa.array(vals["v1"], pa.int64()),
            "v2r": pa.array(vals["v2"], pa.float64()),
            "v3": pa.array(rng.integers(1 << 40, 1 << 41, n), pa.int64()),
            "v4": pa.array(rng.random(n), pa.float64())}))
    for b in new:
        for c, src in (("id", "id"), ("v1", "v1"), ("v2", "v2r"),
                       ("v3", "v3"), ("v4", "v4")):
            cols[c] = np.concatenate([cols[c], b.column(src).to_numpy()])
        old = np.concatenate([old, np.zeros(b.num_rows, dtype=bool)])
    # the last writers among the first winners and every later row
    later = np.concatenate([win, np.arange(rows, len(old))])
    win = later[clock("oracle_s", last_writer_oracle, cols["id"][later])]
    n_new = sum(b.num_rows for b in new)

    def write_evolved():
        for b in new:
            wb = evolved.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())

    rec.run(name, "evolved write", n_new, dev, write_evolved)
    schema_ids = {f.schema_id for s in evolved.new_scan().plan().splits
                  for f in s.data_files}
    if schema_ids != {0, 1}:
        raise AssertionError(f"{name}: runs of schemas {schema_ids}")
    total = len(cols["id"])
    clock("check_s", check_evolved, f"{name} evolved merge-on-read scan",
          rec.run(name, "evolved scan", total, dev, evolved.to_arrow),
          cols, win, old)
    if rec.run(name, "evolved compact", total, dev,
               lambda: evolved.compact(full=True)) is None:
        raise AssertionError(f"{name}: evolved compaction committed nothing")
    clock("check_s", check_evolved, f"{name} evolved read after compaction",
          rec.run(name, "evolved read", len(win), dev, evolved.to_arrow),
          cols, win, old)
    ids, buckets = clock("bucket_ids_s", bucket_ids, evolved)
    out["evolved_index"] = clock("index_check_s", check_hash_index,
                                 f"{name} evolved", evolved, ids, buckets,
                                 target)
    out["evolution_s"] = time.perf_counter() - t0
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def xpart_upsert(work: str, rec: Recorder, device, scale: int) -> dict:
    """xpart_upsert_125K: cross-partition upsert (primary key id,
    partition dt INT of 4 values, bucket unset): 125K keys in 4 commits
    from one writer; then a fresh table object's writer (the global index
    bootstraps from the table) upserts 15.625K ids a commit for 4 commits, a
    quarter of them moving partition and 1% of those moving again later
    in the same batch; each id held once, in the partition of its last
    write, before and after a full compaction."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType

    name = "xpart_upsert_125K"
    path = os.path.join(work, name)
    keys, target = XPART_KEYS // scale, BM_TARGET // scale
    opts = {"write-only": "true", "parquet.enable.dictionary": "false"}
    if target != BM_TARGET:
        opts["dynamic-bucket.target-row-num"] = str(target)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType()).column("dt", IntType(False))
              .partition_keys("dt").primary_key("id").options(opts)
              .build())
    rng = np.random.default_rng(7)

    def batch(ids, dt):
        t = value_table(ids, random_values(rng, len(ids)))
        return t.append_column("dt", pa.array(dt.astype(np.int32),
                                              pa.int32()))

    out = {"keys": keys}
    clock = Clock(out)
    t0 = time.perf_counter()
    cur = rng.integers(0, XPART_PARTS, keys)        # partition of each id
    first = [batch(ids, cur[ids])
             for ids in np.array_split(rng.permutation(keys), 4)]
    upserts, moved = [], 0
    for _ in range(4):
        ids = rng.choice(keys, XPART_UPSERTS // scale, replace=False)
        dt = cur[ids].copy()
        move = rng.random(len(ids)) < 0.25
        dt[move] = (dt[move] + rng.integers(1, XPART_PARTS,
                                            move.sum())) % XPART_PARTS
        twice = np.flatnonzero(move)[:len(ids) // 100]
        dt2 = (dt[twice] + rng.integers(1, XPART_PARTS, len(twice))) \
            % XPART_PARTS
        ids, dt = np.concatenate([ids, ids[twice]]), np.concatenate([dt, dt2])
        moved += int(move.sum()) + len(twice)
        cur[ids] = dt
        upserts.append(batch(ids, dt))
    allb = first + upserts
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in allb])
            for c in ("id", "v1", "v2", "v3", "dt")}
    out["data_s"] = time.perf_counter() - t0
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, schema, device=device)
    dev = table.device
    out.update(upserts=sum(b.num_rows for b in upserts), moved_rows=moved)

    def write(t, batches, what):
        wb = t.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)
            out[f"{what}_bootstrap_s"] = w._write.bootstrap_seconds
            out[f"{what}_assign_s"] = w._write.inner.assign_seconds

    rec.run(name, "write", keys, dev, lambda: write(table, first, "write"))
    fresh = FileStoreTable.load(path, device=device)
    rec.run(name, "upsert", out["upserts"], dev,
            lambda: write(fresh, upserts, "upsert"))
    total = len(cols["id"])
    clock("check_s", check_rows, f"{name} merge-on-read scan",
          rec.run(name, "scan", total, dev, fresh.to_arrow), cols, win, "id")
    if rec.run(name, "compact", total, dev,
               lambda: fresh.compact(full=True)) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    clock("check_s", check_rows, f"{name} read after compaction",
          rec.run(name, "read", keys, dev, fresh.to_arrow), cols, win, "id")
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def postpone(work: str, rec: Recorder, device, scale: int) -> dict:
    """postpone_500K: bucket=-2, deduplicate, write-only; 500K rows in 4
    commits staged un-hashed (a scan sees none of them, as the
    reference's does), then rescale_postpone at the postpone defaults
    (5M rows a bucket) and a scan held against the oracle, the rescaled
    hash index against the rows."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "postpone_500K"
    path = os.path.join(work, name)
    rows, per_bucket = POSTPONE_ROWS // scale, POSTPONE_TARGET // scale
    opts = {"bucket": "-2", "write-only": "true",
            "parquet.enable.dictionary": "false"}
    if per_bucket != POSTPONE_TARGET:
        opts["postpone.target-row-num-per-bucket"] = str(per_bucket)
    out = {"rows": rows}
    clock = Clock(out)
    rng = np.random.default_rng(7)
    batches = clock("data_s", lambda: [
        value_table(rng.integers(0, rows, rows // 4),
                    random_values(rng, rows // 4)) for _ in range(4)])
    cols = clock("data_s", lambda: {
        c: np.concatenate([b.column(c).to_numpy() for b in batches])
        for c in ("id", "v1", "v2", "v3")})
    win = clock("oracle_s", last_writer_oracle, cols["id"])
    table = FileStoreTable.create(path, bigint_schema(opts), device=device)
    dev = table.device

    def write():
        wb = table.new_stream_write_builder()
        with wb.new_write() as w:
            commit = wb.new_commit()
            for k, b in enumerate(batches):
                w.write_arrow(b)
                commit.commit(w.prepare_commit(), commit_identifier=k)

    rec.run(name, "write", rows, dev, write)
    staged = rec.run(name, "scan staged", rows, dev, table.to_arrow)
    if staged.num_rows:
        raise AssertionError(f"{name}: {staged.num_rows} staged rows read")
    if rec.run(name, "rescale", rows, dev, table.rescale_postpone) is None:
        raise AssertionError(f"{name}: the rescale committed nothing")
    clock("check_s", check_rows, f"{name} read after rescale",
          rec.run(name, "read", len(win), dev, table.to_arrow), cols, win,
          "id")
    ids, buckets = clock("bucket_ids_s", bucket_ids, table)
    out["index"] = clock("index_check_s", check_hash_index, name, table, ids,
                         buckets, per_bucket)
    clock("cleanup_s", shutil.rmtree, path, True)
    return out


def bucket_modes(work: str, rec: Recorder, device="cuda",
                 scale: int = 1) -> dict:
    """The three bucket-mode tables on the card (`scale` divides every
    row count and bucket target, for a rehearsal); their seconds by
    table."""
    out = {}
    t_all = time.perf_counter()
    for name, fn in (("dyn_dedup_3.5M", dyn_dedup),
                     ("xpart_upsert_125K", xpart_upsert),
                     ("postpone_500K", postpone)):
        t0 = time.perf_counter()
        out[name] = fn(work, rec, device, scale)
        out[name]["s"] = time.perf_counter() - t0
        out[name]["phases"] = {p["phase"]: {k: p[k] for k in (
            "rows", "s", "rows_per_s", "launches_plain", "launches_ovc",
            "peak_gib")} for p in rec.phases if p["table"] == name}
        log(f"  {name}: {out[name]['s']:.1f} s {json.dumps(out[name])}")
    out["s"] = time.perf_counter() - t_all
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- the maintenance plane: expiry, tags, branches, partitions, fsck ---------

MAINT_DAYS = 6
MAINT_COMMITS = 24               # 4 a day: the watermark 6 hours apart
#                                  (48, 8 a day, until the stream phase)
MAINT_DAILY = MAINT_COMMITS // MAINT_DAYS
MAINT_HOURS = 24 // MAINT_DAILY
MAINT_PER_COMMIT = 15_625        # 375K rows in all (3M until the formats
#                                  phase came, 12M until the append
                                 # phase came, then 6M, 1.5M until the
                                 # stream phase, 750K until the lake
                                 # phase: the script's time)
MAINT_KEYS = 1_000_000           # ids uniform in [0, 1M) within a day
MAINT_DELETE_SHARE = 0.02        # -D rows
MAINT_BRANCH_UPSERTS = 31_250    # 250K until the formats phase came,
                                 # 125K until the stream phase, 62.5K
                                 # until the lake phase
MAINT_END_INPUT = 100_000        # the end-input batch commit
HOUR_MS = 3_600_000
DAY_MS = 24 * HOUR_MS


class MaintCommitCallback:
    """The maintenance table's `commit.callbacks` class: counts calls."""
    calls = 0

    def __init__(self, param=None):
        self.param = param

    def call(self, table, snapshot_id, messages):
        MaintCommitCallback.calls += 1


class MaintState:
    """The visible rows of the maintenance table by (day, id), held in
    numpy at index day * keys + id: the oracle, and the fold of a
    consumer's stream."""

    def __init__(self, keys: int, days: int = MAINT_DAYS):
        self.keys = keys
        self.live = np.zeros(days * keys, dtype=bool)
        self.cols = {"v1": np.zeros(days * keys, np.int64),
                     "v2": np.zeros(days * keys, np.float64),
                     "v3": np.zeros(days * keys, np.int32)}

    def copy(self) -> "MaintState":
        out = MaintState.__new__(MaintState)
        out.keys = self.keys
        out.live = self.live.copy()
        out.cols = {c: v.copy() for c, v in self.cols.items()}
        return out

    def apply(self, idx: np.ndarray, kinds: np.ndarray, vals: dict) -> None:
        """Rows in write order: a key's last row decides (+I/+U sets the
        row, -U/-D removes it)."""
        _, first_rev = np.unique(idx[::-1], return_index=True)
        last = len(idx) - 1 - first_rev
        u, k = idx[last], kinds[last]
        keep = (k == 0) | (k == 2)
        self.live[u[~keep]] = False
        self.live[u[keep]] = True
        for c in C5_VALUE_COLS:
            self.cols[c][u[keep]] = vals[c][last][keep]

    def only_days(self, days) -> "MaintState":
        out = self.copy()
        mask = np.zeros(len(self.live) // self.keys, dtype=bool)
        mask[list(days)] = True
        out.live &= np.repeat(mask, self.keys)
        return out

    def merged(self, other: "MaintState", days) -> "MaintState":
        """This state with `days` taken from `other`."""
        out = self.copy()
        sel = np.zeros(len(self.live) // self.keys, dtype=bool)
        sel[list(days)] = True
        sel = np.repeat(sel, self.keys)
        out.live[sel] = other.live[sel]
        for c in C5_VALUE_COLS:
            out.cols[c][sel] = other.cols[c][sel]
        return out

    def rows(self) -> int:
        return int(self.live.sum())


def maint_dates(days: int = MAINT_DAYS) -> list:
    import datetime
    d0 = datetime.date(2026, 7, 1)
    return [d0 + datetime.timedelta(days=d) for d in range(days)]


def maint_index(t, keys: int, days: int = MAINT_DAYS) -> np.ndarray:
    """day * keys + id of each row of a read."""
    import pyarrow as pa
    import pyarrow.compute as pc
    days = pa.array([d.strftime("%Y%m%d") for d in maint_dates(days)])
    day = pc.index_in(t.column("dt"), value_set=days)
    if day.null_count:
        raise AssertionError("a row of an unknown partition")
    return day.to_numpy(zero_copy_only=False).astype(np.int64) * keys + \
        t.column("id").to_numpy()


def maint_check(what: str, got, want: MaintState) -> None:
    """The rows read equal the oracle's, exactly."""
    idx = maint_index(got, want.keys, len(want.live) // want.keys)
    order = np.argsort(idx, kind="stable")
    exp = np.flatnonzero(want.live)
    if not np.array_equal(idx[order], exp):
        raise AssertionError(f"{what}: {len(idx)} rows, oracle {len(exp)}, "
                             f"or other keys")
    for c in C5_VALUE_COLS:
        if not np.array_equal(got.column(c).to_numpy()[order],
                              want.cols[c][exp]):
            raise AssertionError(f"{what}: column {c} differs from the "
                                 f"oracle")


def same_state(what: str, got: MaintState, want: MaintState) -> None:
    if not np.array_equal(got.live, want.live) or not all(
            np.array_equal(got.cols[c][want.live], want.cols[c][want.live])
            for c in C5_VALUE_COLS):
        raise AssertionError(f"{what} differs from the oracle")


def stream_fold(t, keys: int, state: MaintState) -> int:
    """Fold a stream read (with its sequence numbers) into `state` in
    sequence order; returns its rows."""
    from paimon_tpu_torch.core.read import ROW_KIND_COL
    from paimon_tpu_torch.ops.merge import SEQ_COL
    if not t.num_rows:
        return 0
    idx = maint_index(t, keys, len(state.live) // keys)
    order = np.lexsort([t.column(SEQ_COL).to_numpy(), idx])
    vals = {c: t.column(c).to_numpy()[order] for c in C5_VALUE_COLS}
    state.apply(idx[order], t.column(ROW_KIND_COL).to_numpy()[order], vals)
    return t.num_rows


def drain_stream(scan, read, keys: int, state: MaintState,
                 checkpoint: bool = True) -> int:
    rows = 0
    while True:
        plan = scan.plan()
        if plan is None:
            return rows
        rows += stream_fold(read.to_arrow(plan), keys, state)
        if checkpoint:
            scan.notify_checkpoint_complete(scan.checkpoint())


def referenced_files(table, snapshots, changelogs) -> set:
    """Names of the data and changelog files that the snapshots (and
    tags) and the decoupled changelog entries reference: ADDs of a
    snapshot's base and delta manifests not cancelled by a DELETE, and
    every ADD of the changelog manifests (all an entry keeps)."""
    from paimon_tpu_torch.manifest import FileKind
    scan = table.new_scan()
    cache: dict = {}

    def entries(list_name):
        if not list_name:
            return []
        out = []
        for m in scan.manifest_list.read(list_name):
            if m.file_name not in cache:
                cache[m.file_name] = scan.manifest_file.read(m.file_name)
            out.extend(cache[m.file_name])
        return out

    names = set()
    for s in changelogs:
        names.update(e.file.file_name
                     for e in entries(s.changelog_manifest_list)
                     if e.kind == FileKind.ADD)
    for s in snapshots:
        live = {}
        for e in entries(s.base_manifest_list) + \
                entries(s.delta_manifest_list):
            key = (e.partition, e.bucket, e.file.file_name)
            if e.kind == FileKind.ADD:
                live[key] = True
            else:
                live.pop(key, None)
        names.update(k[2] for k in live)
        names.update(e.file.file_name
                     for e in entries(s.changelog_manifest_list)
                     if e.kind == FileKind.ADD)
    return names


def files_on_disk(table) -> set:
    out = set()
    for root, _, files in os.walk(table.path):
        if os.path.basename(root).startswith("bucket-"):
            out.update(f for f in files
                       if f.startswith(("data-", "changelog-")))
    return out


def kv_rows(path: str) -> dict:
    """id, sequence number, value kind and values of a data file."""
    import pyarrow.parquet as pq
    # the file alone: a dataset read would take the dt=... directory
    # above it for a partition column
    t = pq.ParquetFile(path).read(columns=[
        "id", "_SEQUENCE_NUMBER", "_VALUE_KIND", *C5_VALUE_COLS])
    return {c: t.column(c).to_numpy() for c in t.column_names}


def maintenance(work: str, rec: Recorder, device="cuda",
                scale: int = 1) -> dict:
    """maint_daily_375K: a production daily-partitioned primary-key table
    maintained as the Paimon docs' Maintenance pages set it up, every
    read held against a numpy oracle (`scale` divides the row and key
    counts, for a rehearsal).  Returns what the phase reports."""
    import datetime

    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.maintenance import (
        ViolationKind, fix_violations, mark_done,
    )
    from paimon_tpu_torch.maintenance.partition_expire import (
        partition_time_ms,
    )
    from paimon_tpu_torch.snapshot import ChangelogManager
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import (
        BigIntType, DoubleType, IntType, VarCharType,
    )

    name = "maint_daily_375K"
    path = os.path.join(work, name)
    per, keys = MAINT_PER_COMMIT // scale, MAINT_KEYS // scale
    dates = maint_dates()
    dts = [d.strftime("%Y%m%d") for d in dates]
    tag_names = [d.strftime("%Y-%m-%d") for d in dates]
    wm0 = int(datetime.datetime(2026, 7, 1, tzinfo=datetime.timezone.utc)
              .timestamp() * 1000)
    opts = {"bucket": "2", "changelog-producer": "input",
            "parquet.enable.dictionary": "false",
            "tag.automatic-creation": "watermark",
            "tag.creation-period": "daily", "tag.num-retained-max": "4",
            "snapshot.num-retained.min": "10",
            "snapshot.num-retained.max": "20",
            "changelog.num-retained.max": "40",
            "partition.expiration-time": "3 d",
            "partition.timestamp-formatter": "yyyyMMdd",
            "partition.mark-done-action": "success-file,done-partition",
            "commit.callbacks": f"{__name__}:MaintCommitCallback"}
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType())
              .column("dt", VarCharType(nullable=False))
              .partition_keys("dt").primary_key("dt", "id")
              .options(opts).build())
    out = {"rows": per * MAINT_COMMITS, "commits": MAINT_COMMITS,
           "steps_s": {}}
    clock = Clock(out)
    t_phase = time.perf_counter()

    def step(what, fn, rows=None):
        """A step of the phase: a recorded phase when it reads, writes
        or merges `rows` rows, else timed on the host clock."""
        t0 = time.perf_counter()
        res = rec.run(name, what, rows, dev, fn) if rows is not None \
            else fn()
        out["steps_s"][what] = time.perf_counter() - t0
        return res

    rng = np.random.default_rng(7)

    def batch(ids, dt, deletes=True):
        n = len(ids)
        vals = random_values(rng, n)
        kinds = (np.where(rng.random(n) < MAINT_DELETE_SHARE, 3, 0)
                 if deletes else np.zeros(n)).astype(np.int8)
        t = pa.table({"id": pa.array(ids, pa.int64()),
                      "v1": pa.array(vals["v1"], pa.int64()),
                      "v2": pa.array(vals["v2"], pa.float64()),
                      "v3": pa.array(vals["v3"], pa.int32()),
                      "dt": pa.array([dt] * n, pa.string())})
        return t, kinds, vals

    batches = clock("data_s", lambda: [
        batch(rng.integers(0, keys, per), dts[c // MAINT_DAILY])
        for c in range(MAINT_COMMITS)])
    table = FileStoreTable.create(path, schema, device=device)
    dev = table.device
    state = MaintState(keys)
    tag_states = {}
    MaintCommitCallback.calls = 0

    # a streaming consumer with a consumer id, polled after each day
    consumer = table.copy({"consumer-id": "maint-consumer",
                           "table-read.sequence-number.enabled": "true"})
    crb = consumer.new_read_builder()
    cscan, cread = crb.new_stream_scan(), crb.new_read()
    folded = MaintState(keys)
    polled = 0

    writer_builder = table.new_stream_write_builder() \
        .with_commit_user("maint-writer")
    writer, committer = writer_builder.new_write(), \
        writer_builder.new_commit()
    try:
        for day in range(MAINT_DAYS):
            def write_day():
                for c in range(MAINT_DAILY * day, MAINT_DAILY * (day + 1)):
                    t, kinds, _ = batches[c]
                    writer.write_arrow(t, kinds)
                    sid = committer.commit(writer.prepare_commit(),
                                           commit_identifier=c,
                                           watermark=wm0 + (c + 1)
                                           * MAINT_HOURS * HOUR_MS)
                    if sid is None:
                        raise AssertionError(f"{name}: commit {c} made no "
                                             f"snapshot")
            step(f"write day {day}", write_day, rows=MAINT_DAILY * per)
            for c in range(MAINT_DAILY * day, MAINT_DAILY * (day + 1)):
                t, kinds, vals = batches[c]
                clock("oracle_s", state.apply, day * keys +
                      t.column("id").to_numpy(), kinds, vals)
            tag_states[tag_names[day]] = clock("oracle_s", state.copy)
            polled += step(f"consumer poll day {day}",
                           lambda: drain_stream(cscan, cread, keys, folded),
                           rows=MAINT_DAILY * per)
            clock("check_s", same_state, f"{name}: the consumer's folded "
                  f"stream after day {day}", folded, state)
    finally:
        writer.close()
    del batches
    out["consumer_rows"] = polled
    if MaintCommitCallback.calls != MAINT_COMMITS:
        raise AssertionError(f"{name}: the commit callback ran "
                             f"{MaintCommitCallback.calls} times, expected "
                             f"{MAINT_COMMITS}")
    out["callback_calls"] = MaintCommitCallback.calls
    wm = table.latest_snapshot().watermark
    if wm != wm0 + MAINT_COMMITS * MAINT_HOURS * HOUR_MS:
        raise AssertionError(f"{name}: the snapshot watermark is {wm}")

    # 1. auto-tags: one a day, the 4 newest kept, each read at its snapshot
    tags = table.tag_manager.tags()
    if sorted(tags) != tag_names[-4:]:
        raise AssertionError(f"{name}: tags {sorted(tags)}, expected "
                             f"{tag_names[-4:]}")
    out["tags"] = {n: s.id for n, s in tags.items()}

    def check_tags(when):
        for tag in sorted(tags):
            got = step(f"{when} tag {tag}", table.copy(
                {"scan.tag-name": tag}).to_arrow,
                rows=tag_states[tag].rows())
            clock("check_s", maint_check, f"{name} {when} tag {tag}", got,
                  tag_states[tag])

    check_tags("scan")
    final = state.copy()

    # 2. incremental reads between two tags, and from a tag to the tip
    between = f"{tag_names[2]},{tag_names[4]}"
    got = step("incremental between tags", table.copy(
        {"incremental-between": between}).to_arrow,
        rows=tag_states[tag_names[4]].only_days((3, 4)).rows())
    clock("check_s", maint_check, f"{name} incremental-between {between}",
          got, tag_states[tag_names[4]].only_days((3, 4)))
    tip = table.snapshot_manager.latest_snapshot_id()
    to_snap = f"{tag_names[3]},{tip}"
    got = step("incremental tag to snapshot", table.copy(
        {"incremental-between-tag-to-snapshot": to_snap}).to_arrow,
        rows=final.only_days((4, 5)).rows())
    clock("check_s", maint_check,
          f"{name} incremental-between-tag-to-snapshot {to_snap}", got,
          final.only_days((4, 5)))

    # 3. snapshot expiry at the table's options
    sm = table.snapshot_manager
    before_files = files_on_disk(table)
    snapshots_before = sm.snapshot_count()
    res = step("expire_snapshots", table.expire_snapshots)
    cm = ChangelogManager(table.file_io, table.path)
    changelogs = cm._ids()
    if sm.snapshot_count() != 20 or \
            len(res.expired_snapshots) != snapshots_before - 20:
        raise AssertionError(f"{name}: {sm.snapshot_count()} snapshots "
                             f"left of {snapshots_before}, "
                             f"{len(res.expired_snapshots)} expired")
    if changelogs != res.expired_snapshots:
        raise AssertionError(f"{name}: decoupled changelog {changelogs} "
                             f"for expired {res.expired_snapshots}")
    pinned = clock("check_s", referenced_files, table,
                   list(sm.snapshots()) + list(tags.values()),
                   [cm.changelog(i) for i in changelogs])
    after_files = files_on_disk(table)
    if after_files != pinned:
        raise AssertionError(
            f"{name}: after expiry {len(after_files)} files on disk, the "
            f"snapshots, tags and changelogs reference {len(pinned)} "
            f"({len(after_files - pinned)} left over, "
            f"{len(pinned - after_files)} missing)")
    out["expired"] = {"snapshots": len(res.expired_snapshots),
                      "changelogs_kept": len(changelogs),
                      "data_files": res.deleted_data_files,
                      "manifest_files": res.deleted_manifest_files,
                      "files_on_disk_before": len(before_files),
                      "files_on_disk_after": len(after_files)}
    got = step("scan after expiry", table.to_arrow, rows=final.rows())
    clock("check_s", maint_check, f"{name} scan after expiry", got, final)
    check_tags("after expiry")
    fresh = MaintState(keys)
    fresh_table = table.copy({"scan.mode": "from-snapshot",
                              "scan.snapshot-id": str(changelogs[0]),
                              "table-read.sequence-number.enabled": "true"})
    frb = fresh_table.new_read_builder()
    out["fresh_consumer_rows"] = step(
        "fresh consumer from the earliest changelog",
        lambda: drain_stream(frb.new_stream_scan(), frb.new_read(), keys,
                             fresh, checkpoint=False),
        rows=per * MAINT_COMMITS)
    clock("check_s", same_state, f"{name}: a fresh consumer's folded "
          f"stream from changelog {changelogs[0]}", fresh, final)

    # 4. partitions: expiry relative to the newest, then an end-input
    #    batch commit marks its partitions done
    now = partition_time_ms(table.options, {"dt": dts[-1]}) + DAY_MS
    expired = step("expire_partitions",
                   lambda: table.expire_partitions(now_ms=now))
    if expired != [(d,) for d in dts[:3]]:
        raise AssertionError(f"{name}: expired partitions {expired}")
    state = final.only_days((3, 4, 5))
    got = step("scan after partition expiry", table.to_arrow,
               rows=state.rows())
    clock("check_s", maint_check, f"{name} scan after partition expiry",
          got, state)
    ended = table.copy({"partition.end-input-to-done": "true"})
    parts = []
    for day in (4, 5):
        t, kinds, vals = batch(rng.integers(0, keys, MAINT_END_INPUT
                                            // scale), dts[day],
                               deletes=False)
        parts.append(t)
        state.apply(day * keys + t.column("id").to_numpy(), kinds, vals)

    def end_input():
        wb = ended.new_batch_write_builder()
        with wb.new_write() as w:
            for t in parts:
                w.write_arrow(t)
            wb.new_commit().commit(w.prepare_commit())
    step("end-input batch commit", end_input,
         rows=sum(t.num_rows for t in parts))
    done = mark_done.AddDonePartitionAction(table.file_io,
                                            table.path).done_partitions()
    marked = sorted(d for d in dts if os.path.exists(
        os.path.join(table.path, f"dt={d}", mark_done.SUCCESS_FILE_NAME)))
    if marked != dts[4:] or done != [f"dt={d}.done" for d in dts[4:]]:
        raise AssertionError(f"{name}: marked done {marked}, done "
                             f"partitions {done}")
    got = step("scan after end input", table.to_arrow, rows=state.rows())
    clock("check_s", maint_check, f"{name} scan after end input", got, state)

    # 5. branches: from the oldest kept tag, upserts to an expired day
    base_tag = tag_names[2]
    table.create_branch("backfill", base_tag)
    branch = table.copy({"branch": "backfill"})
    b_state = tag_states[base_tag].copy()
    t, kinds, vals = batch(rng.integers(0, keys, MAINT_BRANCH_UPSERTS
                                        // scale), dts[1], deletes=False)
    b_state.apply(keys + t.column("id").to_numpy(), kinds, vals)

    def branch_write():
        wb = branch.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(t)
            wb.new_commit().commit(w.prepare_commit())
    step("branch write", branch_write, rows=t.num_rows)
    got = step("branch scan", branch.to_arrow, rows=b_state.rows())
    clock("check_s", maint_check, f"{name} branch scan", got, b_state)
    with_fb = state.merged(b_state, (0, 1, 2))
    got = step("fallback scan", table.copy(
        {"scan.fallback-branch": "backfill"}).to_arrow, rows=with_fb.rows())
    clock("check_s", maint_check, f"{name} scan with fallback branch", got,
          with_fb)
    step("fast_forward", lambda: table.fast_forward("backfill"))
    main = FileStoreTable.load(path, device=device)
    got = step("scan after fast_forward", main.to_arrow,
               rows=b_state.rows())
    clock("check_s", maint_check, f"{name} scan after fast_forward", got,
          b_state)
    step("rollback_to", lambda: main.rollback_to(tags[base_tag].id))
    state = tag_states[base_tag].copy()
    got = step("scan after rollback_to", main.to_arrow, rows=state.rows())
    clock("check_s", maint_check, f"{name} scan after rollback_to", got,
          state)

    # 6. clean-up and checks
    if step("compact_manifests", main.compact_manifests) is None:
        raise AssertionError(f"{name}: compact_manifests committed nothing")
    old = time.time() - 2 * DAY_MS / 1000
    planted = []
    for rel in (f"dt={dts[0]}/bucket-0/data-orphan-0.parquet",
                f"dt={dts[1]}/bucket-1/changelog-orphan-0.parquet",
                "manifest/manifest-orphan-0"):
        p = os.path.join(path, rel)
        with open(p, "wb") as f:
            f.write(b"orphan")
        os.utime(p, (old, old))
        planted.append(p)
    live_before = files_on_disk(main) - {os.path.basename(p)
                                         for p in planted}
    removed = step("remove_orphan_files", main.remove_orphan_files)
    if sorted(removed) != sorted(planted) or \
            files_on_disk(main) != live_before:
        raise AssertionError(f"{name}: orphan clean removed {removed}, "
                             f"planted {planted}")
    out["orphans_removed"] = len(removed)
    report = step("fsck deep", lambda: main.fsck(deep=True))
    if not report.ok:
        raise AssertionError(f"{name}: fsck {report.to_dict()}")
    out["fsck"] = {k: getattr(report, k) for k in (
        "snapshots_checked", "manifests_checked", "data_files_checked",
        "manifest_entries_decoded")}
    # lose one data file of day 0, bucket 0: fsck finds it, the repair
    # drops it, and the bucket reads as its remaining files merge
    scan = main.new_scan()
    split = [s for s in main.new_read_builder().new_scan().plan().splits
             if s.partition == (dts[0],) and s.bucket == 0][0]
    files = {f.file_name: scan.path_factory.data_file_path(
        split.partition, 0, f.file_name) for f in split.data_files}
    victim = max(split.data_files, key=lambda f: f.row_count).file_name
    kept = [kv_rows(p) for n, p in files.items() if n != victim]
    lost_ids = kv_rows(files[victim])["id"]
    os.remove(files[victim])
    report = step("fsck after a lost file", main.fsck)
    lost = report.by_kind(ViolationKind.DANGLING_DATA_FILE)
    if not lost or {v.obj for v in lost} != {victim}:
        raise AssertionError(f"{name}: fsck {report.to_dict()}")
    actions = step("fix_violations", lambda: fix_violations(main, report))
    if "remove-unexisting-files" not in actions or \
            not main.fsck(all_snapshots=False).ok:
        raise AssertionError(f"{name}: repair {actions} left violations")
    out["repair_actions"] = actions
    # the oracle: the bucket's keys as its remaining files merge
    in_bucket = np.unique(np.concatenate([lost_ids] + [k["id"]
                                                      for k in kept]))
    state.live[in_bucket] = False          # day 0: index == id
    rest = {c: np.concatenate([k[c] for k in kept]) for c in kept[0]}
    order = np.lexsort([rest["_SEQUENCE_NUMBER"], rest["id"]])
    state.apply(rest["id"][order], rest["_VALUE_KIND"][order],
                {c: rest[c][order] for c in C5_VALUE_COLS})
    if step("compact", lambda: main.compact(full=True),
            rows=state.rows()) is None:
        raise AssertionError(f"{name}: the final full compaction "
                             f"committed nothing")
    got = step("read", main.to_arrow, rows=state.rows())
    clock("check_s", maint_check, f"{name} read after the repair", got,
          state)
    out["final_rows"] = state.rows()

    mine = [p for p in rec.phases if p["table"] == name]
    writes = [p for p in mine if p["phase"].startswith("write day")]
    reads = [p for p in mine if "scan" in p["phase"] or p["phase"] == "read"]
    out["write_rows_per_s"] = sum(p["rows"] for p in writes) / sum(
        p["s"] for p in writes)
    out["read_rows_per_s"] = sum(p["rows"] for p in reads) / sum(
        p["s"] for p in reads)
    out["launches_plain"] = sum(p["launches_plain"] for p in mine)
    out["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    out["launch_shapes"] = sorted(
        [list(k[1:4]) + [k[4], v] for k, v in rec.capture.calls.items()
         if k[0] == name])
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- the read and write planes: spilling writes, local merge, the plan
#    cache and the stats sidecar, retries, upload staging, corrupt files ---

WRP_SPILL_CALLS = 24             # spill_bucket_24M: 24 write_arrow calls
WRP_SPILL_PER_CALL = 1_000_000   # of 1M ids uniform in [0, 12M)
WRP_SPILL_KEYS = 12_000_000
WRP_SPILL_RUNS = 8               # 3 calls of 28 MB >= 64 MiB: 8 spills
WRP_FOLD_PER_CALL = 25_000       # spill_fold_coverage: 24 calls of 25K
WRP_FOLD_KEYS = 3_000_000        # ids uniform in [0, 3M), 1 MB spills,
WRP_FOLD_SPILL_MB = 1            # an 8 MB disk cap (100K, 12M, 4 MB and
WRP_FOLD_DISK_MB = 8             # 32 MB until the append phase came;
                                 # 50K, 6M, 2 MB, 16 MB until search)
WRP_LM_COMMITS = 8               # local_merge_hot_1M: 8 commits of 250K
WRP_LM_PER_COMMIT = 125_000      # (8M rows until the append phase came,
#                                  4M until the SQL phase)
WRP_LM_HOT = 1_000               # half of each commit on 1,000 hot ids,
WRP_LM_KEYS = 1_000_000          # the other half uniform in [0, 1M)
WRP_PLAN_COMMITS = 12            # plan_daily_600K: 12 commits of 50K rows
                                 # (120 until the file-index phase came)
WRP_PLAN_PER_COMMIT = 50_000
WRP_PLAN_DAYS = 12
WRP_PLAN_KEYS = 200_000          # ids uniform in [0, 200K) a day
WRP_PLAN_COLD_EVERY = 10         # a cold plan every 10th commit
WRP_FAULT_COMMITS = 4            # faults_500K: 4 commits of 250K rows
WRP_FAULT_PER_COMMIT = 125_000   # (4M rows until the append phase came,
WRP_FAULT_KEYS = 500_000         # 2M until the SQL phase)
WRP_FAULT_ONE_IN = 20            # data-file writes and reads failing once
MiB = 1 << 20


class FaultyFileIO:
    """faults_500K's store: the first attempt at every WRP_FAULT_ONE_IN-th
    data-file write, and once armed every such read, raises
    TransientStoreError (by a seeded count of calls; a retry of a file
    that failed goes through, since staged uploads and read retries keep
    its name), so every retry ladder ends and each fault is one retry."""

    def __init__(self, inner, seed: int = 7):
        self.inner = inner
        self.offset = seed % WRP_FAULT_ONE_IN
        self.reads_armed = False
        self.faults = {"write": 0, "read": 0}
        self._calls = {"write": 0, "read": 0}
        self._failed: set = set()
        self._lock = threading.Lock()

    def _maybe_fail(self, op: str, path: str) -> None:
        from paimon_tpu_torch.fs.object_store import TransientStoreError
        name = path.rsplit("/", 1)[-1]
        if not name.startswith("data-") or \
                (op == "read" and not self.reads_armed):
            return
        with self._lock:
            k = self._calls[op]
            self._calls[op] += 1
            if k % WRP_FAULT_ONE_IN != self.offset or \
                    (op, name) in self._failed:
                return
            self._failed.add((op, name))
            self.faults[op] += 1
        raise TransientStoreError(f"503 on the first {op} of {name}")

    def write_bytes(self, path, data, overwrite=True):
        self._maybe_fail("write", path)
        return self.inner.write_bytes(path, data, overwrite=overwrite)

    def read_bytes(self, path):
        self._maybe_fail("read", path)
        return self.inner.read_bytes(path)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class SpillTimer:
    """Counts the writer's spills (the calls that raise its
    `_spills_scheduled`) and times its spill merges and folds and the
    local merger's folds: calls, seconds and kernel launches of each (the
    launch
    counter's change across the call; no other merge runs beside these
    in the tables that read them), and the spill directory's bytes as a
    spill merge starts (its peak: runs only accumulate until then)."""

    def __init__(self):
        self.stats = {k: {"calls": 0, "s": 0.0, "launches": 0}
                      for k in ("spill", "spill_merge", "fold",
                                "local_merge")}
        self.peak_spill_bytes = 0
        self.spill_dirs: list = []

    def _timed(self, key: str, fn):
        from paimon_tpu_torch.ops import kernels

        def wrapper(obj, *a, **kw):
            if key == "spill_merge":
                self.peak_spill_bytes = max(
                    self.peak_spill_bytes,
                    sum(os.path.getsize(p) for p in obj.spills))
                self.spill_dirs.append(obj._spill_dir)
            launches = kernels.EQ_NEXT_LAUNCHES
            t0 = time.perf_counter()
            try:
                return fn(obj, *a, **kw)
            finally:
                st = self.stats[key]
                st["calls"] += 1
                st["s"] += time.perf_counter() - t0
                st["launches"] += kernels.EQ_NEXT_LAUNCHES - launches
        return wrapper

    def __enter__(self):
        from paimon_tpu_torch.core import write
        self._write = write
        self._orig = (write._BucketWriter._spill,
                      write._BucketWriter._merge_spills,
                      write._BucketWriter._fold_spills,
                      write.LocalMerger.flush)
        write._BucketWriter._spill = self._timed("spill", self._orig[0])
        write._BucketWriter._merge_spills = self._timed(
            "spill_merge", self._orig[1])
        write._BucketWriter._fold_spills = self._timed("fold", self._orig[2])
        write.LocalMerger.flush = self._timed("local_merge", self._orig[3])
        return self

    def __exit__(self, *exc):
        w = self._write
        (w._BucketWriter._spill, w._BucketWriter._merge_spills,
         w._BucketWriter._fold_spills, w.LocalMerger.flush) = self._orig


def plane_counters() -> dict:
    """The read and write planes' process counters (metrics.py)."""
    from paimon_tpu_torch import metrics as m
    reg = m.global_registry()
    return {"read_retries": reg.scan_metrics().counter(
                m.SCAN_READ_RETRIES).count,
            "write_retries": reg.write_metrics().counter(
                m.WRITE_RETRIES).count,
            "staged_uploads": reg.cache_disk_metrics().counter(
                m.CACHE_DISK_STAGED_UPLOADS).count,
            **{k: reg.plan_metrics().counter(k).count for k in (
                m.PLAN_PLANS, m.PLAN_DELTA_APPLIES, m.PLAN_MANIFESTS_READ,
                m.PLAN_MANIFESTS_PRUNED, m.PLAN_ENTRIES_DECODED,
                m.PLAN_SIDECAR_FALLBACKS)}}


def counter_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in plane_counters().items()}


def new_file_keys(msgs) -> list:
    """(bucket, rows, min id, max id) of each new L0 file of a commit."""
    from paimon_tpu_torch.data.binary_row import BinaryRowCodec
    from paimon_tpu_torch.types import BigIntType
    codec = BinaryRowCodec([BigIntType(False)])
    return [(m.bucket, f.row_count, codec.from_bytes(f.min_key)[0],
             codec.from_bytes(f.max_key)[0])
            for m in sorted(msgs, key=lambda m: m.bucket)
            for f in m.new_files]


def bench_rows(rng, ids: np.ndarray):
    return value_table(ids, random_values(rng, len(ids)))


def spill_bucket(work: str, rec: Recorder, timer: SpillTimer, dev,
                 scale: int) -> dict:
    """spill_bucket_24M: one bucket loaded in one batch commit with
    write-buffer-spillable and write-only (the full compaction after it
    is the table's compaction job, as the Paimon docs' dedicated
    compaction sets it up), everything else at the defaults."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "spill_bucket_24M"
    per, keys = WRP_SPILL_PER_CALL // scale, WRP_SPILL_KEYS // scale
    rows = per * WRP_SPILL_CALLS
    opts = {"bucket": "1", "write-buffer-spillable": "true",
            "write-only": "true"}
    if scale > 1:                       # a rehearsal: the same cadence
        opts["sort-spill-buffer-size"] = str(64 * MiB // scale)
        opts["target-file-size"] = str(128 * MiB // scale)
    rng = np.random.default_rng(7)
    batches = [bench_rows(rng, rng.integers(0, keys, per))
               for _ in range(WRP_SPILL_CALLS)]
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    win = last_writer_oracle(cols["id"])
    table = FileStoreTable.create(os.path.join(work, name),
                                  bigint_schema(opts), device=dev)
    out = {"rows": rows, "calls": WRP_SPILL_CALLS}
    before = dict(timer.stats["spill_merge"])
    spills0 = timer.stats["spill"]["calls"]
    launches0 = rec.counts()[0]

    def write():
        wb = table.new_batch_write_builder()
        with wb.new_write() as w:
            for b in batches:
                w.write_arrow(b)
            msgs = w.prepare_commit()
            wb.new_commit().commit(msgs)
        return msgs

    msgs = rec.run(name, "write (spills, merge at prepare-commit)", rows,
                   dev, write)
    spills = timer.stats["spill"]["calls"] - spills0
    if spills != WRP_SPILL_RUNS:
        raise AssertionError(f"{name}: {spills} spills, expected "
                             f"{WRP_SPILL_RUNS}")
    merge = {k: timer.stats["spill_merge"][k] - before[k] for k in before}
    write_launches = rec.counts()[0] - launches0
    files = new_file_keys(msgs)
    if any(files[i][3] >= files[i + 1][2] for i in range(len(files) - 1)):
        raise AssertionError(f"{name}: L0 files not sorted and disjoint: "
                             f"{files}")
    if sum(f[1] for f in files) != len(win):
        raise AssertionError(f"{name}: L0 rows {sum(f[1] for f in files)}, "
                             f"oracle {len(win)}")
    if merge["calls"] != 1 or merge["launches"] == 0 or \
            write_launches - merge["launches"] == 0:
        raise AssertionError(f"{name}: the spill merges launched "
                             f"{write_launches - merge['launches']} "
                             f"(chunks) and {merge['launches']} (final "
                             f"merge) kernels in {merge['calls']} merges")
    if any(d is not None and os.path.exists(d) for d in timer.spill_dirs):
        raise AssertionError(f"{name}: a spill directory outlived the "
                             f"commit")

    def check(what, got):
        check_rows(f"{name} {what}", got, cols, win, "id")
    check("merge-on-read scan", rec.run(name, "scan", len(win), dev,
                                        table.to_arrow))
    if rec.run(name, "compact", len(win), dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: the full compaction committed "
                             f"nothing")
    check("read after compaction", rec.run(name, "read", len(win), dev,
                                           table.to_arrow))
    w = [p for p in rec.phases if p["table"] == name]
    out.update({"spills": spills, "l0_files": len(files),
                "distinct_ids": int(len(win)),
                "write_rows_per_s": w[0]["rows_per_s"],
                "write_s": w[0]["s"],
                "spill_merge_s": merge["s"],
                "spill_merge_launches": merge["launches"],
                "spill_chunk_launches": write_launches - merge["launches"],
                "peak_spill_dir_bytes": timer.peak_spill_bytes,
                "scan_rows_per_s": w[1]["rows_per_s"],
                "compact_rows_per_s": w[2]["rows_per_s"],
                "read_rows_per_s": w[3]["rows_per_s"],
                "peak_gib": max((p["peak_gib"] or 0) for p in w)})
    shutil.rmtree(table.path, ignore_errors=True)
    return out


def spill_fold(work: str, rec: Recorder, timer: SpillTimer, dev,
               scale: int) -> dict:
    """spill_fold_coverage: 1 MB spills, 4 file handles and an 8 MB disk
    cap, so runs fold and the cap forces early flushes; its L0 files
    held file for file against the same writes run by the port on the
    CPU (serial flushes, so the disk cap sees the same bytes on both)."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "spill_fold_coverage"
    per = WRP_FOLD_PER_CALL // scale
    opts = {"bucket": "1", "write-buffer-spillable": "true",
            "sort-spill-buffer-size": str(WRP_FOLD_SPILL_MB * MiB // scale),
            "local-sort.max-num-file-handles": "4",
            "write-buffer-spill.max-disk-size": str(WRP_FOLD_DISK_MB * MiB
                                                    // scale),
            "write.flush.parallelism": "1"}
    rng = np.random.default_rng(8)
    batches = [bench_rows(rng, rng.integers(0, WRP_FOLD_KEYS // scale, per))
               for _ in range(WRP_SPILL_CALLS)]
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    win = last_writer_oracle(cols["id"])
    runs = {}
    for where in dict.fromkeys((dev.type, "cpu")):
        table = FileStoreTable.create(os.path.join(work, f"{name}_{where}"),
                                      bigint_schema(opts), device=where)
        folds = timer.stats["fold"]["calls"]

        def write():
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                for b in batches:
                    w.write_arrow(b)
                msgs = w.prepare_commit()
                wb.new_commit().commit(msgs)
            return msgs
        msgs = rec.run(name, f"write on {where}", per * WRP_SPILL_CALLS,
                       table.device, write)
        got = table.to_arrow()
        check_rows(f"{name} read on {where}", got, cols, win, "id")
        runs[where] = (new_file_keys(msgs),
                       timer.stats["fold"]["calls"] - folds)
        shutil.rmtree(table.path, ignore_errors=True)
    files, folds = runs[dev.type]
    if runs[dev.type] != runs["cpu"]:
        raise AssertionError(f"{name}: L0 files on {dev.type} "
                             f"{runs[dev.type]} != cpu {runs['cpu']}")
    disjoint = all(files[i][3] < files[i + 1][2]
                   for i in range(len(files) - 1))
    if folds == 0 or disjoint:
        raise AssertionError(f"{name}: {folds} folds, {len(files)} L0 "
                             f"files all disjoint: no early flush")
    return {"l0_files": len(files), "folds": folds,
            "l0_rows": [f[1] for f in files]}


def local_merge_hot(work: str, rec: Recorder, timer: SpillTimer, dev,
                    scale: int) -> dict:
    """local_merge_hot_1M: skewed streaming upserts folded before bucket
    routing (the Paimon docs' Local Merging, at its suggested 64 MB)."""
    from paimon_tpu_torch.table import FileStoreTable

    name = "local_merge_hot_1M"
    per, keys = WRP_LM_PER_COMMIT // scale, WRP_LM_KEYS // scale
    opts = {"bucket": "4", "local-merge-buffer-size": "64mb"}
    table = FileStoreTable.create(os.path.join(work, name),
                                  bigint_schema(opts), device=dev)
    rng = np.random.default_rng(9)
    all_ids, all_vals, per_commit = [], [], []
    builder = table.new_stream_write_builder()
    writer, committer = builder.new_write(), builder.new_commit()
    before = dict(timer.stats["local_merge"])
    try:
        for c in range(WRP_LM_COMMITS):
            ids = np.concatenate([rng.integers(0, WRP_LM_HOT, per // 2),
                                  rng.integers(0, keys, per - per // 2)])
            rng.shuffle(ids)
            batch = bench_rows(rng, ids)
            all_ids.append(ids)
            all_vals.append(batch)

            def commit(c=c, batch=batch):
                writer.write_arrow(batch)
                msgs = writer.prepare_commit()
                committer.commit(msgs, commit_identifier=c)
                return sum(f.row_count for m in msgs for f in m.new_files)
            l0 = rec.run(name, f"write commit {c}", per, dev, commit)
            distinct = len(np.unique(ids))
            if l0 != distinct:
                raise AssertionError(f"{name}: commit {c} wrote {l0} L0 "
                                     f"rows, {distinct} distinct ids")
            per_commit.append(int(l0))
    finally:
        writer.close()
    folds = {k: timer.stats["local_merge"][k] - before[k] for k in before}
    if folds["calls"] != WRP_LM_COMMITS or folds["launches"] == 0:
        raise AssertionError(f"{name}: {folds}")
    cols = {"id": np.concatenate(all_ids),
            **{c: np.concatenate([b.column(c).to_numpy() for b in all_vals])
               for c in ("v1", "v2", "v3")}}
    win = last_writer_oracle(cols["id"])
    check_rows(f"{name} read", rec.run(name, "read", len(win), dev,
                                       table.to_arrow), cols, win, "id")
    w = [p for p in rec.phases if p["table"] == name and
         p["phase"].startswith("write")]
    shutil.rmtree(table.path, ignore_errors=True)
    return {"rows": per * WRP_LM_COMMITS, "l0_rows_per_commit": per_commit,
            "folds": folds["calls"], "fold_s": folds["s"],
            "fold_launches": folds["launches"],
            "write_rows_per_s": sum(p["rows"] for p in w)
            / sum(p["s"] for p in w)}


def plan_daily(work: str, rec: Recorder, dev, scale: int) -> dict:
    """plan_daily_600K: the delta-apply plan cache and the stats sidecar at
    the defaults on a daily-partitioned table with inline compaction."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import (
        BigIntType, DoubleType, IntType, VarCharType,
    )

    name = "plan_daily_600K"
    per, keys = WRP_PLAN_PER_COMMIT // scale, WRP_PLAN_KEYS // scale
    days = WRP_PLAN_DAYS
    daily = WRP_PLAN_COMMITS // days
    dts = [d.strftime("%Y%m%d") for d in maint_dates(days)]
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType())
              .column("dt", VarCharType(nullable=False))
              .partition_keys("dt").primary_key("dt", "id")
              .options({"bucket": "2"}).build())
    table = FileStoreTable.create(os.path.join(work, name), schema,
                                  device=dev)
    rng = np.random.default_rng(10)
    state = MaintState(keys, days)
    out = {"rows": per * WRP_PLAN_COMMITS, "commits": WRP_PLAN_COMMITS}
    cached_s, cold_s, consumer_rows = [], [], 0
    folded = None
    consumer = table.copy({"scan.mode": "latest",
                           "table-read.sequence-number.enabled": "true"})
    builder = table.new_stream_write_builder()
    writer, committer = builder.new_write(), builder.new_commit()
    counters = plane_counters()
    rollback_to = rollback_state = None

    def canon(plan):
        return [(s.partition, s.bucket, tuple(sorted(
            f.file_name for f in s.data_files))) for s in plan.splits]

    def cold_plan(t=None):
        return (t or table).copy({"scan.plan.cache": "false"}) \
            .new_scan().plan()

    t_write = 0.0
    launches0 = rec.counts()
    # the loop below is recorded as one phase after it: name it for the
    # launch capture's shapes now
    rec.capture.where = f"{name} write"
    if dev.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()
    try:
        for c in range(WRP_PLAN_COMMITS):
            day = c // daily
            ids = rng.integers(0, keys, per)
            vals = random_values(rng, per)
            batch = value_table(ids, vals).append_column(
                "dt", pa.array([dts[day]] * per, pa.string()))
            t0 = time.perf_counter()
            writer.write_arrow(batch)
            committer.commit(writer.prepare_commit(), commit_identifier=c)
            t_write += time.perf_counter() - t0
            state.apply(day * keys + ids, np.zeros(per, np.int8), vals)
            if folded is None:
                # the consumer starts at the latest snapshot: it sees
                # every commit after the first
                folded = state.copy()
                cscan = consumer.new_read_builder().new_stream_scan()
                cread = consumer.new_read_builder().new_read()
                cscan.plan()
            else:
                consumer_rows += drain_stream(cscan, cread, keys, folded,
                                              checkpoint=False)
            t0 = time.perf_counter()
            cached = table.new_scan().plan()
            cached_s.append(time.perf_counter() - t0)
            if (c + 1) % WRP_PLAN_COLD_EVERY == 0:
                t0 = time.perf_counter()
                cold = cold_plan(FileStoreTable.load(table.path,
                                                     device=dev))
                cold_s.append(time.perf_counter() - t0)
                if canon(cached) != canon(cold):
                    raise AssertionError(f"{name}: commit {c}: the cached "
                                         f"plan differs from a cold plan")
                same_state(f"{name}: the consumer's stream after commit "
                           f"{c}", folded, state)
            if c == WRP_PLAN_COMMITS - 2 * daily:
                rollback_to = table.latest_snapshot().id
                rollback_state = state.copy()
    finally:
        writer.close()
    launched = tuple(a - b for a, b in zip(rec.counts(), launches0))
    # the launches of the loop: the writes' and the consumer's merges
    rec.add(name, f"write, {WRP_PLAN_COMMITS} commits with inline "
            f"compaction",
            per * WRP_PLAN_COMMITS, dev, t_write, launched)
    got = rec.run(name, "read", state.rows(), dev, table.to_arrow)
    maint_check(f"{name} read", got, state)

    # the cached and the cold plan at the tip, as a pair
    t0 = time.perf_counter()
    tip = table.new_scan().plan()
    tip_cached = time.perf_counter() - t0
    t0 = time.perf_counter()
    tip_cold = cold_plan()
    tip_cold_s = time.perf_counter() - t0
    if canon(tip) != canon(tip_cold):
        raise AssertionError(f"{name}: the tip's cached plan differs")

    def follows(what):
        """The plan after `what` equals a cold walk; the read equals the
        oracle."""
        if canon(table.new_scan().plan()) != canon(cold_plan()):
            raise AssertionError(f"{name}: the plan after {what} differs "
                                 f"from a cold plan")
        maint_check(f"{name} read after {what}", rec.run(
            name, f"read after {what}", state.rows(), dev,
            table.to_arrow), state)

    # an INSERT OVERWRITE of day 0 (invalidates the cached state)
    ids = rng.integers(0, keys, per)
    vals = random_values(rng, per)
    wb = table.new_batch_write_builder().with_overwrite({"dt": dts[0]})
    with wb.new_write() as w:
        w.write_arrow(value_table(ids, vals).append_column(
            "dt", pa.array([dts[0]] * per, pa.string())))
        wb.new_commit().commit(w.prepare_commit())
    state.live[:keys] = False
    state.apply(ids, np.zeros(per, np.int8), vals)
    follows("the overwrite of a day")

    # a late correction of the last day's top id band: a commit whose
    # manifest holds only ids >= 95% of the range, which the key-range
    # plan below prunes (every other manifest spans the whole range)
    ids = rng.integers(keys - keys // 20, keys, per // 5)
    vals = random_values(rng, len(ids))
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(value_table(ids, vals).append_column(
            "dt", pa.array([dts[-1]] * len(ids), pa.string())))
        wb.new_commit().commit(w.prepare_commit())
    state.apply((days - 1) * keys + ids, np.zeros(len(ids), np.int8), vals)
    follows("a late correction of an id band")

    # filtered plans, one day and a key range: each served from the
    # cached state, and walked cold by a fresh table object (a planner
    # in another process), whose sidecar prune skips whole manifests
    def filtered(what, want, **kw):
        moved = {}
        for how, t in (("cached", table), ("cold", FileStoreTable.load(
                table.path, dynamic_options={"scan.plan.cache": "false"},
                device=dev))):
            rb = t.new_read_builder()
            if "partition" in kw:
                rb = rb.with_partition_filter(kw["partition"])
            if "predicate" in kw:
                rb = rb.with_filter(kw["predicate"])
            before = plane_counters()
            got = rec.run(name, f"{how} scan of {what}", want.rows(), dev,
                          lambda: rb.new_read().to_arrow(
                              rb.new_scan().plan()))
            moved[how] = counter_delta(before)
            maint_check(f"{name} {how} scan of {what}", got, want)
        if moved["cold"]["sidecar_fallbacks"] or \
                moved["cached"]["sidecar_fallbacks"]:
            raise AssertionError(f"{name} {what}: sidecar fallbacks "
                                 f"{moved}")
        return moved

    day_plan = filtered("one day", state.only_days([5]),
                        partition={"dt": dts[5]})
    low = state.copy()
    low.live &= np.tile(np.arange(keys) < 1000, days)
    key_plan = filtered("id < 1000", low,
                        predicate=P.less_than("id", 1000))
    if day_plan["cold"]["manifests_pruned"] == 0 or \
            key_plan["cold"]["manifests_pruned"] == 0:
        raise AssertionError(f"{name}: a cold filtered plan pruned no "
                             f"manifest: {day_plan}, {key_plan}")

    # rollback_to an earlier snapshot (recreates ids the cache has seen)
    table.rollback_to(rollback_to)
    state = rollback_state
    follows(f"rollback_to {rollback_to}")
    plans = counter_delta(counters)
    w = [p for p in rec.phases if p["table"] == name]
    out.update({"write_rows_per_s": w[0]["rows_per_s"],
                "consumer_rows": consumer_rows,
                "cached_plan_s": {"mean": float(np.mean(cached_s)),
                                  "max": max(cached_s)},
                "cold_plan_s": {"mean": float(np.mean(cold_s)),
                                "max": max(cold_s)},
                "tip_plan_s": {"cached": tip_cached, "cold": tip_cold_s},
                "one_day_plan": day_plan, "key_range_plan": key_plan,
                "counters": plans, "live_rows": state.rows()})
    shutil.rmtree(table.path, ignore_errors=True)
    return out


def faults(work: str, rec: Recorder, dev, scale: int) -> dict:
    """faults_500K: retries, upload staging, the prefetch byte budget and
    the corrupt-file skip on a 4-bucket table over FaultyFileIO."""
    import warnings

    from paimon_tpu_torch.format.format import CorruptDataError
    from paimon_tpu_torch.parallel.scan_pipeline import iter_split_tables
    from paimon_tpu_torch.table import FileStoreTable

    name = "faults_500K"
    per, keys = WRP_FAULT_PER_COMMIT // scale, WRP_FAULT_KEYS // scale
    stage = tempfile.mkdtemp(prefix="paimon-stage-")
    path = os.path.join(work, name)
    opts = {"bucket": "4", "write.retry.max-attempts": "3",
            "read.retry.max-attempts": "3", "write.stage.dir": stage}
    FileStoreTable.create(path, bigint_schema(opts), device=dev)
    from paimon_tpu_torch.fs import get_file_io
    store = FaultyFileIO(get_file_io(path))
    table = FileStoreTable.load(path, file_io=store, device=dev)
    rng = np.random.default_rng(12)
    batches = [bench_rows(rng, rng.integers(0, keys, per))
               for _ in range(WRP_FAULT_COMMITS)]
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    win = last_writer_oracle(cols["id"])
    before = plane_counters()

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write (staged uploads, write retries)",
            per * WRP_FAULT_COMMITS, dev, write)
    if os.listdir(stage):
        raise AssertionError(f"{name}: the stage directory kept "
                             f"{os.listdir(stage)}")
    store.reads_armed = True
    check_rows(f"{name} scan", rec.run(name, "scan (read retries)",
                                       len(win), dev, table.to_arrow),
               cols, win, "id")
    moved = counter_delta(before)
    if moved["write_retries"] != store.faults["write"] or \
            moved["read_retries"] != store.faults["read"] or \
            0 in store.faults.values() or moved["staged_uploads"] == 0:
        raise AssertionError(f"{name}: {moved} for faults {store.faults}")

    # the prefetch byte budget: one split in flight at 1 MiB
    budget = table.copy({"read.prefetch.max-bytes": str(MiB // scale)})
    rb = budget.new_read_builder()
    splits = rb.new_scan().plan().splits
    stats = {}
    n = sum(t.num_rows for _, _, t in iter_split_tables(
        rb.new_read()._read, splits, budget.options, stats=stats))
    largest = max(sum(f.file_size for f in s.data_files) for s in splits)
    if n != len(win) or stats["peak_inflight_bytes"] > largest or \
            stats["max_inflight_splits"] != 1:
        raise AssertionError(f"{name}: budget {stats}, largest split "
                             f"{largest} bytes, {n} rows")

    # the corrupt-file skip: zero the head of bucket 0's oldest file
    bdir = os.path.join(path, "bucket-0")
    data = [os.path.join(bdir, f) for f in os.listdir(bdir)
            if f.startswith("data-")]
    victim = min(data, key=os.path.getmtime)
    kept = [kv_rows(os.path.join(path, b, f))
            for b in sorted(os.listdir(path)) if b.startswith("bucket-")
            for f in os.listdir(os.path.join(path, b))
            if f.startswith("data-") and os.path.join(path, b, f) != victim]
    rest = {c: np.concatenate([k[c] for k in kept]) for c in kept[0]}
    order = np.lexsort([rest["_SEQUENCE_NUMBER"], rest["id"]])
    last = order[np.flatnonzero(np.r_[rest["id"][order][1:]
                                      != rest["id"][order][:-1], True])]
    with open(victim, "r+b") as f:
        f.write(b"\0" * 64)
    try:
        table.to_arrow()
        raise AssertionError(f"{name}: a read of a corrupt file passed")
    except CorruptDataError:
        pass
    lenient = table.copy({"scan.ignore-corrupt-files": "true"})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = rec.run(name, "scan skipping a corrupt file", len(last), dev,
                      lenient.to_arrow)
    check_rows(f"{name} scan without the corrupt file", got,
               {c: rest[c] for c in ("id", "v1", "v2", "v3")},
               last, "id")
    if not any("corrupt" in str(w.message) for w in caught):
        raise AssertionError(f"{name}: the skip did not warn")
    moved = counter_delta(before)
    if moved["write_retries"] + moved["read_retries"] != \
            sum(store.faults.values()):
        raise AssertionError(f"{name}: {moved} for faults {store.faults}")
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(stage, ignore_errors=True)
    w = [p for p in rec.phases if p["table"] == name]
    return {"rows": per * WRP_FAULT_COMMITS, "faults": dict(store.faults),
            "write_retries": moved["write_retries"],
            "read_retries": moved["read_retries"],
            "staged_uploads": moved["staged_uploads"],
            "budget": {"peak_inflight_bytes": stats["peak_inflight_bytes"],
                       "max_inflight_splits": stats["max_inflight_splits"],
                       "largest_split_bytes": largest},
            "corrupt_skip_rows": int(len(last)),
            "write_rows_per_s": w[0]["rows_per_s"],
            "scan_rows_per_s": w[1]["rows_per_s"]}


def write_read_planes(work: str, rec: Recorder, device="cuda",
                      scale: int = 1) -> dict:
    """The read and write planes on the card (`scale` divides the row
    counts and byte options, for a rehearsal).  Returns what the phase
    reports."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    out = {}
    with SpillTimer() as timer:
        out["spill_bucket_24M"] = spill_bucket(work, rec, timer, dev, scale)
        out["spill_fold_coverage"] = spill_fold(work, rec, timer, dev,
                                                scale)
        out["local_merge_hot_1M"] = local_merge_hot(work, rec, timer, dev,
                                                    scale)
    out["plan_daily_600K"] = plan_daily(work, rec, dev, scale)
    out["faults_500K"] = faults(work, rec, dev, scale)
    names = set(out)
    mine = [p for p in rec.phases if p["table"] in names]
    out["launches_plain"] = sum(p["launches_plain"] for p in mine)
    out["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    out["launch_shapes"] = sorted(
        [[k[0]] + list(k[1:4]) + [k[4], v]
         for k, v in rec.capture.calls.items() if k[0] in names])
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- per-file indexes on primary-key tables -----------------------------------

FI_COMMITS = 8                   # fi_point_16M: 8 commits of 2M rows,
FI_PER_COMMIT = 2_000_000        # ids uniform in [0, 8M), 4 buckets
FI_KEYS = 8_000_000
FI_QUERIES = 5                   # present ids, and as many absent ones
#                                  (50 until the formats phase came)
FI_READ_PLANS = 10               # absent-id plans timed per sidecar reader
FI_RW_COMMITS = 4                # fi_rewrite_coverage: 4 commits of 31.25K
FI_RW_PER_COMMIT = 31_250        # ids uniform in [0, 62.5K) (16x that until
FI_RW_KEYS = 62_500              # the append phase came, 8x until the SQL
#                                  phase, 4x until the stream phase, 2x
#                                  until the search phase)
FI_RW_QUERIES = 5
# the Paimon docs' "Data File Index" options, file-index.in-manifest-
# threshold at its 500-byte default
FI_OPTIONS = {"file-index.bloom-filter.columns": "id",
              "file-index.bitmap.columns": "v3",
              "file-index.bsi.columns": "v3",
              "file-index.range-bitmap.columns": "v1"}


class IndexTimer:
    """Calls and seconds of the writers' index builds
    (index/file_index.py build_indexes_blob), summed over the flush and
    compaction threads that run them."""

    def __init__(self):
        self.calls = 0
        self.s = 0.0
        self._lock = threading.Lock()

    def __enter__(self):
        from paimon_tpu_torch.index import file_index
        self._module = file_index
        orig = self._orig = file_index.build_indexes_blob

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                with self._lock:
                    self.calls += 1
                    self.s += time.perf_counter() - t0
        file_index.build_indexes_blob = timed
        return self

    def __exit__(self, *exc):
        self._module.build_indexes_blob = self._orig

    def take(self) -> dict:
        with self._lock:
            out = {"calls": self.calls, "s": self.s}
            self.calls, self.s = 0, 0.0
        return out


def live_entries(table) -> list:
    snap = table.snapshot_manager.latest_snapshot()
    return table.new_scan().read_entries(snap)


def bucket_files(table) -> list:
    """Data files per bucket, in bucket order."""
    counts: dict = {}
    for e in live_entries(table):
        counts[e.bucket] = counts.get(e.bucket, 0) + 1
    return [counts[b] for b in sorted(counts)]


def check_sidecars(what: str, table, paths) -> int:
    """Every live file carries its `.index` sidecar (the blobs exceed
    the 500-byte in-manifest threshold), and each is on disk."""
    n = 0
    for e in live_entries(table):
        f = e.file
        if f.embedded_index is not None or \
                f.extra_files != [f.file_name + ".index"] or \
                not os.path.exists(os.path.join(
                    paths, f"bucket-{e.bucket}", f.extra_files[0])):
            raise AssertionError(f"{what}: {f.file_name} has no sidecar "
                                 f"({f.extra_files})")
        n += 1
    return n


class PointOracle:
    """The last write of every id, for `id = x` queries."""

    def __init__(self, cols: dict):
        self.cols = cols
        self.win = last_writer_oracle(cols["id"])
        self.ids = cols["id"][self.win]

    def want(self, x: int):
        i = int(np.searchsorted(self.ids, x))
        if i < len(self.ids) and self.ids[i] == x:
            return self.win[i:i + 1]
        return self.win[:0]

    def draw(self, rng, keys: int, n: int):
        """`n` ids written and `n` ids in [0, keys) never written."""
        present = rng.choice(self.ids, n, replace=False)
        seen = np.zeros(keys, dtype=bool)
        seen[self.ids] = True
        absent = rng.choice(np.flatnonzero(~seen), n, replace=False)
        return present, absent


def point_queries(what: str, table, oracle: PointOracle, ids) -> dict:
    """Plan and read `id = x` for each id (a fresh scan each, as a user's
    read builder makes one), every answer held against the oracle;
    returns the files planned and the milliseconds of each query and of
    its plan."""
    from paimon_tpu_torch import predicate as P
    files, ms, plan_ms = [], [], []
    for x in ids:
        t0 = time.perf_counter()
        rb = table.new_read_builder().with_filter(P.equal("id", int(x)))
        plan = rb.new_scan().plan()
        t1 = time.perf_counter()
        got = rb.new_read().to_arrow(plan)
        ms.append((time.perf_counter() - t0) * 1e3)
        plan_ms.append((t1 - t0) * 1e3)
        files.append(sum(len(s.data_files) for s in plan.splits))
        check_rows(f"{what}: id = {x}", got, oracle.cols, oracle.want(x),
                   "id")
    return {"files_mean": float(np.mean(files)),
            "files_max": int(max(files)),
            "ms_p50": pct(ms, 50), "ms_p99": pct(ms, 99),
            "plan_ms_p50": pct(plan_ms, 50), "plan_ms_p99": pct(plan_ms, 99)}


def point_rounds(what: str, table, oracle, present, absent, rec, dev,
                 name: str) -> dict:
    out = {"bucket_files": bucket_files(table)}

    def run():
        out["present"] = point_queries(what, table, oracle, present)
        out["absent"] = point_queries(what, table, oracle, absent)
    rec.run(name, what, len(present) + len(absent), dev, run)
    return out


def sidecar_reads(table, ids) -> dict:
    """Plans of `id = x` with each sidecar read by ranges (the scan's
    reader: headers, then the entries of the predicate's columns) and
    read whole (as the reference reads it), alternating; milliseconds a
    plan and the files planned, which must agree."""
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.index import file_index

    ranged = file_index.read_indexes_file

    def whole(file_io, path, columns):
        return file_index.read_indexes_blob(file_io.read_bytes(path))
    ms = {"ranged": [], "whole": []}
    for x in ids:
        files = set()
        for label, reader in (("ranged", ranged), ("whole", whole)):
            file_index.read_indexes_file = reader
            try:
                t0 = time.perf_counter()
                plan = table.new_read_builder().with_filter(
                    P.equal("id", int(x))).new_scan().plan()
                ms[label].append((time.perf_counter() - t0) * 1e3)
            finally:
                file_index.read_indexes_file = ranged
            files.add(sum(len(s.data_files) for s in plan.splits))
        if len(files) != 1:
            raise AssertionError(f"id = {x}: the readers planned {files}")
    return {k: {"plans": len(v), "ms_p50": pct(v, 50),
                "ms_mean": float(np.mean(v))} for k, v in ms.items()}


def fi_point(work: str, rec: Recorder, timer: IndexTimer, dev,
             scale: int) -> dict:
    """fi_point_16M: the file indexes of the Paimon docs' "Data File
    Index" pages on bench.py's rows, written, queried by key and by
    value, compacted and queried again."""
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.table import FileStoreTable

    name = "fi_point_16M"
    per, keys = FI_PER_COMMIT // scale, FI_KEYS // scale
    path = os.path.join(work, name)
    table = FileStoreTable.create(path, bigint_schema({
        "bucket": "4", "write-only": "true",
        "parquet.enable.dictionary": "false", **FI_OPTIONS}), device=dev)
    rng = np.random.default_rng(7)
    batches = [bench_rows(rng, rng.integers(0, keys, per))
               for _ in range(FI_COMMITS)]
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    oracle = PointOracle(cols)
    present, absent = oracle.draw(np.random.default_rng(7), keys,
                                  FI_QUERIES)
    out = {"rows": per * FI_COMMITS, "keys": len(oracle.win)}

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    timer.take()
    rec.run(name, "write", out["rows"], dev, write)
    out["write_rows_per_s"] = rec.phases[-1]["rows_per_s"]
    out["write_index_build"] = timer.take()
    out["sidecars"] = check_sidecars(name, table, path)
    out["before"] = point_rounds("point queries", table, oracle, present,
                                 absent, rec, dev, name)
    held = out["before"]["bucket_files"]
    if out["before"]["present"]["files_mean"] >= min(held) or \
            out["before"]["absent"]["files_mean"] > 1:
        raise AssertionError(f"{name}: the indexes skipped too little: "
                             f"{out['before']}")
    out["sidecar_reads"] = sidecar_reads(table, absent[:FI_READ_PLANS])

    # value predicates: the stats drop v3 = 100 whole; the others read
    # every bucket (a value match may hide a newer version of its key)
    win, v1, v3 = oracle.win, cols["v1"], cols["v3"]
    if table.new_read_builder().with_filter(P.equal("v3", 100)) \
            .new_scan().plan().splits:
        raise AssertionError(f"{name}: v3 = 100 planned splits")
    out["value_rows"] = {}
    for label, pred, sel in (
            ("v3 = 42", P.equal("v3", 42), win[v3[win] == 42]),
            ("v3 < 3", P.less_than("v3", 3), win[v3[win] < 3]),
            ("v1 > 2^39", P.greater_than("v1", 1 << 39),
             win[v1[win] > 1 << 39])):
        got = rec.run(name, f"scan {label}", len(sel), dev,
                      lambda pred=pred: table.to_arrow(predicate=pred))
        check_rows(f"{name} {label}", got, cols, sel, "id")
        out["value_rows"][label] = int(len(sel))

    timer.take()
    if rec.run(name, "compact", out["rows"], dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    out["compact_index_build"] = timer.take()
    out["compacted_sidecars"] = check_sidecars(f"{name} after compaction",
                                               table, path)
    out["after"] = point_rounds("point queries after compaction", table,
                                oracle, present, absent, rec, dev, name)
    if out["after"]["absent"]["files_mean"] > 1:
        raise AssertionError(f"{name}: {out['after']}")
    shutil.rmtree(path, ignore_errors=True)
    return out


def fi_rewrite(work: str, rec: Recorder, timer: IndexTimer, dev,
               scale: int) -> dict:
    """fi_rewrite_coverage: indexes retrofitted by rewrite_file_index on
    a table written without them, a forced rebuild after a change of the
    spec (adding a bloom filter on a string column), and a retried write
    of indexed files."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.fs import get_file_io
    from paimon_tpu_torch.maintenance.repair import rewrite_file_index
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import (
        BigIntType, DoubleType, IntType, VarCharType,
    )

    name = "fi_rewrite_coverage"
    per, keys = FI_RW_PER_COMMIT // scale, FI_RW_KEYS // scale
    path = os.path.join(work, name)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType()).column("name", VarCharType())
              .primary_key("id").options({"bucket": "4",
                                          "write-only": "true"}).build())
    table = FileStoreTable.create(path, schema, device=dev)
    rng = np.random.default_rng(8)

    def batch():
        b = bench_rows(rng, rng.integers(0, keys, per))
        return b.append_column("name", pc.cast(
            pc.divide(b.column("id"), 7), pa.string()))
    batches = [batch() for _ in range(FI_RW_COMMITS + 1)]

    def write(t, bs):
        for b in bs:
            wb = t.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())

    def oracle_of(bs):
        cols = {c: np.concatenate([b.column(c).to_numpy() for b in bs])
                for c in ("id", "v1", "v2", "v3")}
        cols["name"] = pa.concat_arrays([b.column("name").combine_chunks()
                                         for b in bs])
        return PointOracle(cols)

    rows = per * FI_RW_COMMITS
    rec.run(name, "write", rows, dev,
            lambda: write(table, batches[:FI_RW_COMMITS]))
    oracle = oracle_of(batches[:FI_RW_COMMITS])
    present, absent = oracle.draw(np.random.default_rng(8), keys,
                                  FI_RW_QUERIES)
    out = {"rows": rows}
    out["unindexed"] = point_rounds("point queries without indexes", table,
                                    oracle, present, absent, rec, dev, name)
    files = sum(bucket_files(table))
    timer.take()
    bloom = table.copy({"file-index.bloom-filter.columns": "id"})
    out["rewritten"] = rec.run(name, "rewrite_file_index", rows, dev,
                               lambda: rewrite_file_index(bloom))
    wider = table.copy({**FI_OPTIONS,
                        "file-index.bloom-filter.columns": "id,name"})
    out["rewritten_forced"] = rec.run(
        name, "rewrite_file_index(force=True), a bloom on a string column",
        rows, dev, lambda: rewrite_file_index(wider, force=True))
    out["rewrite_index_build"] = timer.take()
    if out["rewritten"] != files or out["rewritten_forced"] != files or \
            rewrite_file_index(wider) != 0:
        raise AssertionError(f"{name}: rewrote {out['rewritten']} and "
                             f"{out['rewritten_forced']} of {files} files")
    check_sidecars(name, wider, path)
    out["indexed"] = point_rounds("point queries after rewrite_file_index",
                                  wider, oracle, present, absent, rec, dev,
                                  name)
    if out["indexed"]["absent"]["files_mean"] > 1 or \
            out["unindexed"]["absent"]["files_mean"] < \
            min(out["unindexed"]["bucket_files"]):
        raise AssertionError(f"{name}: {out['unindexed']} -> "
                             f"{out['indexed']}")
    # the string bloom: an absent name plans nothing, a present one
    # reads its exact rows
    names = oracle.cols["name"].take(pa.array(oracle.win))
    x = names[len(names) // 2].as_py()
    if wider.new_read_builder().with_filter(P.equal("name", "absent")) \
            .new_scan().plan().splits:
        raise AssertionError(f"{name}: an absent name planned splits")
    check_rows(f"{name} name = {x}", wider.to_arrow(
        predicate=P.equal("name", x)), oracle.cols,
        oracle.win[pc.equal(names, x).to_numpy(zero_copy_only=False)], "id")

    # a retried write of indexed files: a data file or sidecar write
    # fails once (faults_500K's store)
    store = FaultyFileIO(get_file_io(path))
    faulty = FileStoreTable.load(path, file_io=store, device=dev,
                                 dynamic_options={
                                     **FI_OPTIONS,
                                     "write.retry.max-attempts": "3"})
    before = plane_counters()
    rec.run(name, "write of indexed files, retried", per, dev,
            lambda: write(faulty, batches[FI_RW_COMMITS:]))
    moved = counter_delta(before)
    if moved["write_retries"] != store.faults["write"] or \
            store.faults["write"] == 0:
        raise AssertionError(f"{name}: {moved} for {store.faults}")
    oracle = oracle_of(batches)
    check_sidecars(f"{name} after the retried write",
                   FileStoreTable.load(path, device=dev), path)
    out["retried"] = point_rounds(
        "point queries after the retried write",
        FileStoreTable.load(path, device=dev, dynamic_options=FI_OPTIONS),
        oracle, present, absent, rec, dev, name)
    out["faults"] = dict(store.faults)
    shutil.rmtree(path, ignore_errors=True)
    return out


def file_indexes(work: str, rec: Recorder, device="cuda",
                 scale: int = 1) -> dict:
    """Per-file indexes on primary-key tables on the card (`scale`
    divides the row counts, for a rehearsal).  Returns what the phase
    reports."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    out = {}
    with IndexTimer() as timer:
        out["fi_point_16M"] = fi_point(work, rec, timer, dev, scale)
        out["fi_rewrite_coverage"] = fi_rewrite(work, rec, timer, dev,
                                                scale)
    names = set(out)
    mine = [p for p in rec.phases if p["table"] in names]
    for p in mine:
        # after the compaction each bucket is one sorted run: its reads
        # need no merge
        if p["phase"] in ("write", "point queries", "compact") and \
                p["table"] == "fi_point_16M" and p["launches_plain"] == 0 \
                and dev.type == "cuda":
            raise AssertionError(f"fi_point_16M {p['phase']}: no launch "
                                 f"of the winner-select")
    out["launches_plain"] = sum(p["launches_plain"] for p in mine)
    out["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    out["launch_shapes"] = sorted(
        [[k[0]] + list(k[1:4]) + [k[4], v]
         for k, v in rec.capture.calls.items() if k[0] in names])
    out["steps"] = {f"{p['table']} {p['phase']}":
                    {"s": p["s"], "rows_per_s": p["rows_per_s"],
                     "launches": p["launches_plain"]} for p in mine}
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- append tables: logs, queues, deletion vectors, sort-compact, row ids -----

AP_LOG_COMMITS = 8               # ap_log_16M: 8 commits of 2^21 rows,
AP_LOG_PER_COMMIT = 1 << 21      # ids uniform in [0, 2^23)
AP_DELETE_SHARE = 100            # delete_where on the lowest 1/100 of
                                 # the ids, then on the highest
AP_BAND = 1 << 16                # the id band planned before and after
AP_SORT_ROWS = 1 << 17           # ap_sort_coverage (2^20 until the
#                                  formats phase came)
AP_SORT_CASES = (("zorder", ("s", "n", "d")), ("hilbert", ("d",)),
                 ("hilbert", ("id", "s", "n", "d")), ("order", ("n", "s")))
AP_TRACKED_COMMITS = 4           # ap_tracked_1M: 4 commits of 2^18 rows
AP_TRACKED_PER_COMMIT = 1 << 18  # (2^20 until the formats phase came, 8
#                                  commits until the stream phase)
AP_TRACKED_SHARE = 100           # 1 row id in 100 updated (twice), deleted
AP_LOOKUPS = 10_000              # global-index lookups, half present
AP_QUEUE_COMMITS = 4             # ap_queue_coverage: bucket=4 by id,
AP_QUEUE_PER_COMMIT = 1 << 17    # 4 commits of 2^17 rows (8 until the
#                                  SQL phase came)
AP_QUEUE_QUERIES = 25            # present ids, and as many absent ones


def append_schema(options):
    """bench.py's columns without a primary key."""
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType
    return (Schema.builder().column("id", BigIntType(False))
            .column("v1", BigIntType()).column("v2", DoubleType())
            .column("v3", IntType()).options(options).build())


def same_rows_in_order(what: str, got, cols: dict, sel=None) -> None:
    """`got` holds the oracle's rows (`sel` of them, a mask or indices)
    in the oracle's order."""
    n = len(cols["id"]) if sel is None else \
        int(sel.sum()) if sel.dtype == bool else len(sel)
    if got.num_rows != n:
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle {n}")
    for c, full in cols.items():
        want = full if sel is None else full[sel]
        if not np.array_equal(got.column(c).to_numpy(), want):
            raise AssertionError(f"{what}: column {c} differs from the "
                                 f"oracle")


def row_hashes(cols: dict) -> np.ndarray:
    """uint64 per row of bench.py's columns (a multiplicative mix of the
    four), for multiset checks of permuted reads."""
    with np.errstate(over="ignore"):
        h = cols["id"].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        for c, k in (("v1", 0xBF58476D1CE4E5B9), ("v2", 0x94D049BB133111EB),
                     ("v3", 0xD6E8FEB86659FD93)):
            v = cols[c].view(np.uint64) if cols[c].dtype == np.float64 \
                else cols[c].astype(np.uint64)
            h = (h ^ (h >> np.uint64(31))) * np.uint64(k) + v
    return h


def same_rows_any_order(what: str, got, want: np.ndarray) -> None:
    """`got` holds the oracle's rows whose `row_hashes` are `want`, in
    any order: the same count, and the same sums of the row hashes and
    of their squares (wrapping 64-bit sums, so the check stays linear at
    16M rows)."""
    def sums(h):
        with np.errstate(over="ignore"):
            return int(h.sum(dtype=np.uint64)), \
                int((h * h).sum(dtype=np.uint64))
    have = row_hashes({c: got.column(c).to_numpy()
                       for c in ("id", "v1", "v2", "v3")})
    if len(have) != len(want) or sums(have) != sums(want):
        raise AssertionError(f"{what}: the rows differ from the oracle's")


def dv_entries(table) -> int:
    """Deletion-vector entries in the latest snapshot's index manifest."""
    snap = table.latest_snapshot()
    if not snap.index_manifest:
        return 0
    return sum(e.index_file.index_type == "DELETION_VECTORS" for e in
               table.new_scan().index_manifest_file.read(
                   snap.index_manifest))


def planned_files(table, pred) -> int:
    return sum(len(s.data_files) for s in table.new_read_builder()
               .with_filter(pred).new_scan().plan().splits)


class SortTimer:
    """Splits sort-compact into its bucket reads and its permutation
    (the host lane encode, then ranks, curve and sort on the card and the
    permutation's copy back); the rest of the step is the write and the
    commit."""

    def __init__(self):
        self.read_s = self.perm_s = self.encode_s = 0.0

    def _timed(self, field, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                setattr(self, field, getattr(self, field)
                        + time.perf_counter() - t0)
        return timed

    def __enter__(self):
        from paimon_tpu_torch.compact import compact_action
        from paimon_tpu_torch.ops import zorder
        fields = {"_read_bucket": "read_s", "_column_lanes": "encode_s"}
        self._saved = [(compact_action, "_read_bucket"),
                       (zorder, "_column_lanes"),
                       (zorder, "z_order_permutation"),
                       (zorder, "hilbert_permutation"),
                       (zorder, "order_permutation")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        for m, n, fn in self._saved:
            setattr(m, n, self._timed(fields.get(n, "perm_s"), fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)


def ap_log(work: str, rec: Recorder, dev, scale: int) -> dict:
    """ap_log_16M: a bucket-unaware log table with deletion vectors
    (the Paimon docs' "Append Table" and "Deletion Vectors" pages),
    written, scanned, deleted from, compacted and sort-compacted by
    z-order (the sort-compact action's `--order_strategy zorder`)."""
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.table import FileStoreTable

    name = "ap_log_16M"
    path = os.path.join(work, name)
    rows = AP_LOG_PER_COMMIT * AP_LOG_COMMITS // scale
    batches = bigint_batches(rows, runs=AP_LOG_COMMITS)
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    table = FileStoreTable.create(path, append_schema({
        "bucket": "-1", "deletion-vectors.enabled": "true",
        "parquet.enable.dictionary": "false",
        # the default 128 MB (4 files after the compaction), kept with
        # a rehearsal's scale
        "target-file-size": f"{128 // scale} mb"}), device=dev)
    out = {"rows": rows, "commits": AP_LOG_COMMITS}

    def step(what, fn, n):
        res = rec.run(name, what, n, dev, fn)
        out[f"{what} rows_per_s"] = rec.phases[-1]["rows_per_s"]
        out[f"{what} s"] = rec.phases[-1]["s"]
        return res

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    step("write", write, rows)
    same_rows_in_order(f"{name} scan", step("scan", table.to_arrow, rows),
                       cols)
    sel = cols["v3"] == 42
    got = step("scan v3 = 42", lambda: table.to_arrow(
        predicate=P.equal("v3", 42)), int(sel.sum()))
    same_rows_in_order(f"{name} v3 = 42", got, cols, sel)

    # two deletes, ids at the bottom and at the top of their range: the
    # bucket bins into several splits, and each delete must leave it one
    # deletion-vector file that holds every split's vectors
    band = rows // 2 // AP_DELETE_SHARE
    keep = (cols["id"] >= band) & (cols["id"] < rows // 2 - band)
    for what, pred in (("delete_where", P.less_than("id", band)),
                       ("delete_where top", P.greater_or_equal(
                           "id", rows // 2 - band))):
        if step(what, lambda: table.delete_where(pred), rows) is None:
            raise AssertionError(f"{name}: {what} committed nothing")
        out[f"{what} dv_entries"] = dv_entries(table)
        if out[f"{what} dv_entries"] != 1:
            raise AssertionError(
                f"{name}: {what} left {out[f'{what} dv_entries']} "
                f"deletion-vector files for the one bucket")
    out["splits"] = len(table.new_read_builder().new_scan().plan().splits)
    out["deleted"] = int((~keep).sum())
    same_rows_in_order(f"{name} scan after the delete",
                       step("scan deleted", table.to_arrow, rows), cols,
                       keep)
    live = int(keep.sum())
    if step("compact", lambda: table.compact(full=True), live) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    if dv_entries(table):
        raise AssertionError(f"{name}: deletion vectors left after the "
                             f"full compaction")
    same_rows_in_order(f"{name} scan after compaction",
                       step("scan compacted", table.to_arrow, live), cols,
                       keep)

    lo = rows // 4
    band_pred = P.and_(P.greater_or_equal("id", lo),
                       P.less_than("id", lo + AP_BAND // scale))
    in_band = keep & (cols["id"] >= lo) & (cols["id"] < lo + AP_BAND // scale)
    out["band_files_before"] = planned_files(table, band_pred)
    with SortTimer() as timer:
        if step("sort_compact", lambda: table.sort_compact(
                ["id", "v3"], "zorder"), live) is None:
            raise AssertionError(f"{name}: sort-compact committed nothing")
    sort_s = rec.phases[-1]["s"]
    out["sort_compact_split_s"] = {
        "read": timer.read_s, "ranks_curve_sort": timer.perm_s,
        "of_which_host_lane_encode": timer.encode_s,
        "write_commit": sort_s - timer.read_s - timer.perm_s}
    out["sort_compact_launches"] = rec.phases[-1]["launches_plain"]
    if dev.type == "cuda" and out["sort_compact_launches"] != 2:
        raise AssertionError(f"{name}: sort-compact launched the "
                             f"winner-select {out['sort_compact_launches']}"
                             f" times, not once a column (2)")
    # the oracle's rows hashed once for both checks
    hashes = row_hashes(cols)
    same_rows_any_order(f"{name} scan after sort-compact",
                        step("scan sorted", table.to_arrow, live),
                        hashes[keep])
    out["band_files_after"] = planned_files(table, band_pred)
    got = step("scan id band", lambda: table.to_arrow(predicate=band_pred),
               int(in_band.sum()))
    same_rows_any_order(f"{name} id band", got, hashes[in_band])
    out["files_after"] = planned_files(table, P.greater_or_equal("id", 0))
    if not out["band_files_after"] < out["band_files_before"]:
        raise AssertionError(f"{name}: the id band plans "
                             f"{out['band_files_after']} files after the "
                             f"sort, {out['band_files_before']} before")
    shutil.rmtree(path, ignore_errors=True)
    return out


def sort_coverage_table(n: int):
    """bench.py's rows (seed 7) and three more columns: a STRING whose
    values share 16-byte prefixes, a nullable INT, a DOUBLE holding -0.0
    and NaN."""
    import pyarrow as pa
    import pyarrow.compute as pc
    t = bigint_batches(2 * n, runs=2)[0]
    rng = np.random.default_rng(7)
    k = rng.integers(0, 5000, n)
    d = rng.normal(size=n)
    d[rng.random(n) < 0.05] = -0.0
    d[rng.random(n) < 0.05] = 0.0
    d[rng.random(n) < 0.05] = np.nan
    short = pc.cast(pa.array(k), pa.string())
    long = pc.binary_join_element_wise("order-key-prefix", short, "")
    return t.append_column("s", pc.if_else(pa.array(k % 4 == 0), short,
                                           long)) \
        .append_column("n", pa.array(rng.integers(-50, 50, n).astype(
            np.int32), pa.int32(), mask=rng.random(n) < 0.125)) \
        .append_column("d", pa.array(d, pa.float64()))


def ap_sort(rec: Recorder, dev, scale: int) -> dict:
    """ap_sort_coverage: every curve of sort-compact on the card (z-order
    on 3 columns, so bit 63 is set; Hilbert on 1 and on 4; order on 2)
    over strings that share their 16-byte prefix, nulls, NaN and -0.0,
    each permutation equal to its plain numpy version."""
    from paimon_tpu_torch.ops import zorder

    name = "ap_sort_coverage"
    n = AP_SORT_ROWS // scale
    t = sort_coverage_table(n)
    # the plain ranks are per column: rank each column once for all cases
    plain_ranks = zorder._normalized_u32_plain
    ranked = {}

    def ranks_once(table, columns):
        for c in columns:
            if c not in ranked:
                ranked[c] = plain_ranks(table, [c])[:, 0]
        return np.stack([ranked[c] for c in columns], axis=1)

    fns = {"zorder": (zorder.z_order_permutation,
                      zorder.z_order_permutation_plain),
           "hilbert": (zorder.hilbert_permutation,
                       zorder.hilbert_permutation_plain),
           "order": (zorder.order_permutation,
                     zorder.order_permutation_plain)}
    out = {"rows": n, "cases": {}}
    zorder._normalized_u32_plain = ranks_once
    try:
        for strategy, columns in AP_SORT_CASES:
            card_fn, plain_fn = fns[strategy]
            what = f"{strategy} {','.join(columns)}"
            got = rec.run(name, what, n, dev,
                          lambda: card_fn(t, list(columns), device=dev))
            t0 = time.perf_counter()
            want = plain_fn(t, list(columns))
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} {what}: the permutation "
                                     f"differs from its plain version")
            out["cases"][what] = {
                "s": rec.phases[-1]["s"], "plain_s":
                time.perf_counter() - t0,
                "launches": rec.phases[-1]["launches_plain"]}
        z = zorder.z_index_plain(t, ["s", "n", "d"])
    finally:
        zorder._normalized_u32_plain = plain_ranks
    out["z_bit63_rows"] = int((z >= np.uint64(1 << 63)).sum())
    if not out["z_bit63_rows"]:
        raise AssertionError(f"{name}: no z-order key with bit 63 set")
    return out


def ap_tracked(work: str, rec: Recorder, dev, scale: int) -> dict:
    """ap_tracked_1M: a row-tracked table (the Paimon docs' "Row
    Tracking" page): column updates and deletes by row id, the global
    index on id and its lookups, a compaction that keeps the row ids."""
    import pyarrow as pa

    from paimon_tpu_torch.table import FileStoreTable

    name = "ap_tracked_1M"
    path = os.path.join(work, name)
    rows = AP_TRACKED_PER_COMMIT * AP_TRACKED_COMMITS // scale
    batches = bigint_batches(rows, runs=AP_TRACKED_COMMITS)
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    alive = np.ones(rows, dtype=bool)
    table = FileStoreTable.create(path, append_schema({
        "bucket": "-1", "row-tracking.enabled": "true",
        "parquet.enable.dictionary": "false"}), device=dev)
    rng = np.random.default_rng(7)
    out = {"rows": rows}

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write", rows, dev, write)
    if table.latest_snapshot().next_row_id != rows:
        raise AssertionError(f"{name}: next row id "
                             f"{table.latest_snapshot().next_row_id}")
    k = rows // AP_TRACKED_SHARE
    for i in (1, 2):
        rids = np.sort(rng.choice(rows, k, replace=False))
        vals = rng.integers(0, 1 << 40, k)
        rec.run(name, f"update_columns {i}", k, dev,
                lambda: table.update_columns(
                    rids, pa.table({"v1": pa.array(vals, pa.int64())})))
        cols["v1"][rids] = vals
    rids = rng.choice(rows, k, replace=False)
    rec.run(name, "delete_by_row_ids", k, dev,
            lambda: table.delete_by_row_ids(rids))
    alive[rids] = False
    out["splits"] = len(table.new_read_builder().new_scan().plan().splits)

    def one_dv_file(what):
        if dv_entries(table) != 1:
            raise AssertionError(f"{name} {what}: {dv_entries(table)} "
                                 f"deletion-vector files for the one "
                                 f"bucket")
    one_dv_file("delete_by_row_ids")

    def check_tracked(what, got):
        if not np.array_equal(got.column("_ROW_ID").to_numpy(),
                              np.flatnonzero(alive)):
            raise AssertionError(f"{name} {what}: row ids differ")
        same_rows_in_order(f"{name} {what}", got, cols, alive)
    live = int(alive.sum())
    check_tracked("read with row ids", rec.run(
        name, "read with row ids", live, dev,
        lambda: table.to_arrow(with_row_ids=True)))

    gi = rec.run(name, "global_index id", live, dev,
                 lambda: table.global_index("id"))
    out["global_index_launches"] = rec.phases[-1]["launches_plain"]
    if dev.type == "cuda" and out["global_index_launches"] != 1:
        raise AssertionError(f"{name}: the global index build launched "
                             f"the winner-select "
                             f"{out['global_index_launches']} times, not 1")
    live_ids, live_rids = cols["id"][alive], np.flatnonzero(alive)
    order = np.argsort(live_ids, kind="stable")
    keys, key_rids = live_ids[order], live_rids[order]
    q = np.concatenate([rng.choice(live_ids, AP_LOOKUPS // 2),
                        rng.integers(0, rows, AP_LOOKUPS // 2)])
    t0 = time.perf_counter()
    got = gi.lookup(q)
    out["lookup_ms"] = (time.perf_counter() - t0) * 1000
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    want = np.where(keys[pos] == q, key_rids[pos], -1)
    if not np.array_equal(got, want):
        raise AssertionError(f"{name}: global-index lookups differ from "
                             f"numpy")
    out["lookups_present"] = int((want >= 0).sum())

    if rec.run(name, "compact", live, dev, table.compact) is None:
        raise AssertionError(f"{name}: the compaction committed nothing")
    files = [f for s in table.new_read_builder().new_scan().plan().splits
             for f in s.data_files]
    if any(f.write_cols is not None for f in files):
        raise AssertionError(f"{name}: overlays left after compaction")
    out["files_after"] = len(files)
    one_dv_file("compact")
    check_tracked("read with row ids after compaction", rec.run(
        name, "read with row ids compacted", live, dev,
        lambda: table.to_arrow(with_row_ids=True)))
    shutil.rmtree(path, ignore_errors=True)
    return out


def ap_queue(work: str, rec: Recorder, dev, scale: int) -> dict:
    """ap_queue_coverage: a fixed-bucket append queue (the Paimon docs'
    "Append Queue" page: bucket=4, bucket-key=id) with a bloom filter on
    id; each commit's streaming delta read, then a
    compaction.min.file-num compaction, then point predicates that the
    file index skips."""
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.table import FileStoreTable

    name = "ap_queue_coverage"
    path = os.path.join(work, name)
    per = AP_QUEUE_PER_COMMIT // scale
    rng = np.random.default_rng(7)
    keys = per * AP_QUEUE_COMMITS
    batches = [bench_rows(rng, rng.integers(0, keys, per))
               for _ in range(AP_QUEUE_COMMITS)]
    table = FileStoreTable.create(path, append_schema({
        "bucket": "4", "bucket-key": "id", "compaction.min.file-num": "3",
        "file-index.bloom-filter.columns": "id",
        "parquet.enable.dictionary": "false"}), device=dev)
    out = {"rows": keys}
    scan = read = None

    def commit_and_poll():
        nonlocal scan, read
        polled = []
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
            if scan is None:
                rb = table.new_read_builder()
                scan, read = rb.new_stream_scan(), rb.new_read()
            polled.append(read.to_arrow(scan.plan()))
        return polled
    polled = rec.run(name, "write and poll", keys, dev, commit_and_poll)
    for i, (b, got) in enumerate(zip(batches, polled)):
        same_rows_any_order(f"{name} delta {i}", got, row_hashes(
            {c: b.column(c).to_numpy() for c in ("id", "v1", "v2", "v3")}))
    if rec.run(name, "compact", keys, dev, table.compact) is None:
        raise AssertionError(f"{name}: compaction.min.file-num picked "
                             f"nothing")
    per_bucket = {}
    for s in table.new_read_builder().new_scan().plan().splits:
        per_bucket[s.bucket] = per_bucket.get(s.bucket, 0) + \
            len(s.data_files)
    if sorted(per_bucket.values()) != [1] * 4:
        raise AssertionError(f"{name}: files per bucket {per_bucket}")
    p = scan.plan()
    if p is not None and read.to_arrow(p).num_rows:
        raise AssertionError(f"{name}: the compaction reached the stream")
    ids = np.concatenate([b.column("id").to_numpy() for b in batches])
    written = np.unique(ids)
    never = np.setdiff1d(np.arange(keys), written)
    present = rng.choice(written, AP_QUEUE_QUERIES, replace=False)
    absent = rng.choice(never, AP_QUEUE_QUERIES, replace=False)

    def query(values):
        files = []
        for v in values:
            pred = P.equal("id", int(v))
            files.append(planned_files(table, pred))
            n = table.to_arrow(predicate=pred).num_rows
            if n != int((ids == v).sum()):
                raise AssertionError(f"{name}: id {v} read {n} rows")
        return float(np.mean(files))
    out["present_files_mean"] = rec.run(name, "point queries", 2 *
                                        AP_QUEUE_QUERIES, dev,
                                        lambda: query(present))
    out["absent_files_mean"] = query(absent)
    if out["present_files_mean"] >= 4 or out["absent_files_mean"] >= 1:
        raise AssertionError(f"{name}: the file index skipped too little: "
                             f"{out}")
    shutil.rmtree(path, ignore_errors=True)
    return out


def append_tables(work: str, rec: Recorder, device="cuda",
                  scale: int = 1) -> dict:
    """Append tables on the card (`scale` divides the row counts, for a
    rehearsal).  Returns what the phase reports."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    out = {"ap_log_16M": ap_log(work, rec, dev, scale),
           "ap_sort_coverage": ap_sort(rec, dev, scale),
           "ap_tracked_1M": ap_tracked(work, rec, dev, scale),
           "ap_queue_coverage": ap_queue(work, rec, dev, scale)}
    names = set(out)
    mine = [p for p in rec.phases if p["table"] in names]
    out["launches_plain"] = sum(p["launches_plain"] for p in mine)
    out["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    out["launch_shapes"] = sorted(
        [[k[0]] + list(k[1:4]) + [k[4], v]
         for k, v in rec.capture.calls.items() if k[0] in names])
    out["steps"] = {f"{p['table']} {p['phase']}":
                    {"s": p["s"], "rows_per_s": p["rows_per_s"],
                     "launches": p["launches_plain"]} for p in mine}
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    if out["peak_gib"] is not None and out["peak_gib"] >= 4:
        raise AssertionError(f"append_tables: peak device memory "
                             f"{out['peak_gib']:.2f} GiB")
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- data formats and types: blob sidecars, VARIANT, avro/csv/json/mosaic ---

FT_MEDIA_COMMITS = 8             # blob_media_2G: 8 commits of 4,096 rows,
FT_MEDIA_PER_COMMIT = 4096       # ids uniform in [0, 16,384), bucket=2:
FT_MEDIA_KEYS = 16_384           # ~2 GiB of image bytes, ~1 GiB a bucket
FT_IMAGE_BYTES = (8 << 10, 120 << 10)   # uniform, a 64 KiB mean
FT_COV_COMMITS = 2               # formats_coverage: 2 commits of 2^12
FT_COV_PER_COMMIT = 1 << 12      # rows, ids uniform in [0, 2^13), bucket=1
FT_COV_KEYS = 1 << 13            # (2^13 in [0, 2^14) until the lake phase)
FT_FORMATS = ("avro", "csv", "json", "mosaic")
FT_FORMAT_TABLE_ROWS = 1 << 13   # a FormatTable's rows, in 4 dt partitions
#                                  (2^16 until the stream phase came, 2^14
#                                  until the lake phase)
FT_TRACKED_ROWS = 1 << 13        # the row-tracked table of $row_tracking
FT_DAYS = ("2024-06-01", "2024-06-02", "2024-06-03", "2024-06-04")


class CountingFileIO:
    """Counts the bytes read from `.blob` sidecars through the table's
    FileIO (every other call delegates)."""

    def __init__(self, inner):
        self.inner = inner
        self.blob_bytes = 0
        self._lock = threading.Lock()

    def _count(self, path, n):
        if path.endswith(".blob"):
            with self._lock:
                self.blob_bytes += n

    def read_bytes(self, path):
        data = self.inner.read_bytes(path)
        self._count(path, len(data))
        return data

    def read_range(self, path, offset, length):
        data = self.inner.read_range(path, offset, length)
        self._count(path, len(data))
        return data

    def read_ranges(self, path, ranges):
        out = self.inner.read_ranges(path, ranges)
        self._count(path, sum(len(b) for b in out))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def row_hashes_of(b, lens: np.ndarray, dev):
    """One 64-bit hash a row of the bytes `b` (a uint8 tensor on `dev`)
    cut into rows of `lens` bytes: the wrapping sum over a row's bytes
    of (byte + 1) times a mixed weight of the byte's position in the
    row (an empty row hashes to 0)."""
    import torch
    n = int(lens.sum())
    if not n:
        return np.zeros(len(lens), dtype=np.uint64)
    lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
    row = torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                  lens_t)
    starts = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lens)[:-1]]).astype(np.int64)).to(dev)
    pos = torch.arange(n, device=dev) - torch.repeat_interleave(starts,
                                                                lens_t)
    w = pos * -7046029254386353131              # 0x9E3779B97F4A7C15
    w ^= w >> 29
    w *= -4658895280553007687                   # 0xBF58476D1CE4E5B9
    w ^= w >> 32
    h = torch.zeros(len(lens), dtype=torch.int64, device=dev)
    h.index_add_(0, row, (b.to(torch.int64) + 1) * w)
    return h.cpu().numpy().view(np.uint64)


def blob_hashes(col, dev) -> np.ndarray:
    """`row_hashes_of` each row of a binary column (a null row as an
    empty one), from the Arrow buffers in chunks moved to `dev`."""
    import warnings

    import pyarrow as pa
    import torch
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    wide = pa.types.is_large_binary(arr.type)
    offs = np.frombuffer(arr.buffers()[1], dtype=np.int64 if wide
                         else np.int32)[arr.offset:arr.offset + len(arr) + 1]
    offs = offs.astype(np.int64)
    lens = np.diff(offs)
    if arr.null_count:
        lens[np.asarray(arr.is_null())] = 0
    data = arr.buffers()[2]
    out = np.zeros(len(arr), dtype=np.uint64)
    chunk = (128 << 20) if dev.type == "cuda" else (16 << 20)
    lo = 0
    while lo < len(arr):
        hi = max(lo + 1, min(len(arr), int(np.searchsorted(
            offs, offs[lo] + chunk, side="right")) - 1))
        n = int(offs[hi] - offs[lo])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # a read-only buffer
            b = torch.from_numpy(np.frombuffer(
                data, dtype=np.uint8, count=n, offset=int(offs[lo]))
                if n else np.zeros(0, np.uint8)).to(dev)
        if arr.null_count:
            # a null row's bytes, if any, are left out of the chunk
            keep = torch.from_numpy(np.repeat(
                lens[lo:hi] > 0, np.diff(offs[lo:hi + 1]))).to(dev)
            b = b[keep]
        out[lo:hi] = row_hashes_of(b, lens[lo:hi], dev)
        lo = hi
    return out


def media_schema(options):
    """bench.py's columns plus `meta VARIANT` and `image BLOB`."""
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import (
        BigIntType, BlobType, DoubleType, IntType, VariantType,
    )
    return (Schema.builder().column("id", BigIntType(False))
            .column("v1", BigIntType()).column("v2", DoubleType())
            .column("v3", IntType()).column("meta", VariantType())
            .column("image", BlobType()).primary_key("id")
            .options(options).build())


def media_batches(scale: int, dev):
    """blob_media_2G's commits from seed 7: bench.py's values, a small
    JSON object (w, h, 0-3 tags) per row as a VARIANT, drawn from a
    seeded pool of 1,024 objects, and an image of random bytes (the
    card's generator, seeded) of a length uniform in FT_IMAGE_BYTES.
    Returns the batches and the oracle's columns (the image as its hash
    and length)."""
    import pyarrow as pa
    import torch

    from paimon_tpu_torch.data.variant import column_from_objects
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    pool_w = rng.integers(64, 4096, 1024)
    pool_h = rng.integers(64, 4096, 1024)
    pool = column_from_objects([
        {"w": int(w), "h": int(h),
         "tags": [f"t{int(t)}" for t in rng.integers(0, 1000,
                                                     rng.integers(0, 4))]}
        for w, h in zip(pool_w, pool_h)])
    per = FT_MEDIA_PER_COMMIT // scale
    batches = []
    cols = {c: [] for c in ("id", "v1", "v2", "v3", "w", "hash", "len")}
    for _ in range(FT_MEDIA_COMMITS):
        ids = rng.integers(0, FT_MEDIA_KEYS // scale, per)
        v1 = rng.integers(0, 1 << 40, per)
        v2 = rng.random(per)
        v3 = rng.integers(0, 100, per).astype(np.int32)
        pick = rng.integers(0, len(pool_w), per)
        lens = rng.integers(FT_IMAGE_BYTES[0], FT_IMAGE_BYTES[1] + 1, per)
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        payload = torch.randint(0, 256, (int(offs[-1]),), generator=gen,
                                dtype=torch.uint8, device=dev)
        cols["hash"].append(row_hashes_of(payload, lens, dev))
        image = pa.Array.from_buffers(
            pa.binary(), per, [None, pa.py_buffer(offs),
                               pa.py_buffer(payload.cpu().numpy())])
        batches.append(pa.table({
            "id": pa.array(ids, pa.int64()), "v1": pa.array(v1, pa.int64()),
            "v2": pa.array(v2, pa.float64()), "v3": pa.array(v3, pa.int32()),
            "meta": pool.take(pa.array(pick)), "image": image}))
        for c, v in (("id", ids), ("v1", v1), ("v2", v2), ("v3", v3),
                     ("w", pool_w[pick]), ("len", lens)):
            cols[c].append(v)
    return batches, {c: np.concatenate(v) for c, v in cols.items()}


def check_media(what: str, got, cols: dict, win: np.ndarray, dev,
                images: bool = True) -> None:
    """`got` holds the winners `win` of the oracle: ids, values and
    (with `images`) each image equal to its last writer's by hash."""
    import pyarrow.compute as pc
    if got.num_rows != len(win):
        raise AssertionError(f"{what}: {got.num_rows} rows, oracle "
                             f"{len(win)}")
    got = got.take(pc.sort_indices(got, sort_keys=[("id", "ascending")]))
    for c in ("id", "v1", "v2", "v3"):
        if not np.array_equal(got.column(c).to_numpy(), cols[c][win]):
            raise AssertionError(f"{what}: column {c} differs from the "
                                 f"oracle")
    if images and not np.array_equal(blob_hashes(got.column("image"), dev),
                                     cols["hash"][win]):
        raise AssertionError(f"{what}: an image differs from its last "
                             f"writer's")


def sidecar_paths(table) -> dict:
    """{data file path: its `.blob` sidecar's path} of the live files."""
    scan = table.new_scan()
    out = {}
    for e in scan.read_entries(table.latest_snapshot()):
        data = scan.path_factory.data_file_path((), e.bucket,
                                                e.file.file_name)
        blobs = [x for x in e.file.extra_files if x.endswith(".blob")]
        if len(blobs) != 1:
            raise AssertionError(f"{e.file.file_name}: sidecars {blobs}")
        out[data] = os.path.join(os.path.dirname(data), blobs[0])
    return out


def files_under(root: str, suffix: str = "") -> dict:
    """{path: size} of every file under `root` ending in `suffix`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(suffix):
                p = os.path.join(d, n)
                out[p] = os.path.getsize(p)
    return out


def blob_media(work: str, rec: Recorder, dev, scale: int) -> tuple:
    """blob_media_2G, the slice's full-size path (the Paimon docs'
    "Blob" and "Data Distribution" pages: 200 MB-1 GB a bucket): a
    primary-key table with a VARIANT and a BLOB column, written, scanned
    with each image checked by hash, projected without the images,
    queried by variant path, deleted from, fully compacted, expired and
    cleaned of orphans, then $files and $audit_log.  Returns the report,
    the table, the oracle's columns and its live rows."""
    from paimon_tpu_torch import predicate as P
    from paimon_tpu_torch.data.variant import column_to_variants, variant_get
    from paimon_tpu_torch.fs import LocalFileIO
    from paimon_tpu_torch.table import FileStoreTable

    name = "blob_media_2G"
    path = os.path.join(work, name)
    t0 = time.perf_counter()
    batches, cols = media_batches(scale, dev)
    rows = len(cols["id"])
    out = {"rows": rows, "commits": FT_MEDIA_COMMITS,
           "image_bytes": int(cols["len"].sum()),
           "data_s": time.perf_counter() - t0}
    win = last_writer_oracle(cols["id"])
    table = FileStoreTable.create(path, media_schema({
        "bucket": "2", "write-only": "true",
        "parquet.enable.dictionary": "false"}), device=dev)

    def step(what, fn, n, blob_bytes=None):
        res = rec.run(name, what, n, dev, fn)
        s = rec.phases[-1]["s"]
        out[f"{what} s"] = s
        out[f"{what} rows_per_s"] = n / s
        if blob_bytes is not None:
            out[f"{what} blob_bytes_per_s"] = blob_bytes / s
        return res

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    step("write", write, rows, out["image_bytes"])
    del batches
    live_bytes = int(cols["len"][win].sum())
    out["sidecars_after_write"] = len(sidecar_paths(table))
    got = step("scan", table.to_arrow, rows, live_bytes)
    check_media(f"{name} merge-on-read scan", got, cols, win, dev)
    del got

    counting = CountingFileIO(LocalFileIO())
    projected = FileStoreTable.load(path, file_io=counting, device=dev)
    got = step("scan without image", lambda: projected.to_arrow(
        projection=["id", "v1", "v2", "v3", "meta"]), rows)
    check_media(f"{name} projection without image", got, cols, win, dev,
                images=False)
    out["projection_blob_bytes_read"] = counting.blob_bytes
    if counting.blob_bytes:
        raise AssertionError(f"{name}: the projection without image read "
                             f"{counting.blob_bytes} bytes of sidecars")
    t0 = time.perf_counter()
    got = got.sort_by("id")
    ws = [variant_get(v, "$.w") for v in column_to_variants(
        got.column("meta"))]
    out["variant_get s"] = time.perf_counter() - t0
    if not np.array_equal(np.array(ws, dtype=np.int64), cols["w"][win]):
        raise AssertionError(f"{name}: variant_get(meta, '$.w') differs "
                             f"from the oracle")
    del got

    cut = FT_MEDIA_KEYS // scale // 100
    if step("delete_where", lambda: table.delete_where(
            P.less_than("id", cut)), rows) is None:
        raise AssertionError(f"{name}: delete_where committed nothing")
    win = win[cols["id"][win] >= cut]
    live_bytes = int(cols["len"][win].sum())
    out["deleted_ids"] = int(len(last_writer_oracle(cols["id"])) - len(win))
    if step("compact", lambda: table.compact(full=True), rows,
            out["image_bytes"]) is None:
        raise AssertionError(f"{name}: full compaction committed nothing")
    sidecars = sidecar_paths(table)
    out["sidecar_bytes_after_compaction"] = sum(
        os.path.getsize(p) for p in sidecars.values())
    if out["sidecar_bytes_after_compaction"] != live_bytes:
        raise AssertionError(f"{name}: the compacted sidecars hold "
                             f"{out['sidecar_bytes_after_compaction']} "
                             f"bytes, the winners' images {live_bytes}")
    got = step("scan compacted", table.to_arrow, len(win), live_bytes)
    check_media(f"{name} scan after compaction", got, cols, win, dev)
    del got

    before = files_under(path, ".blob")
    t0 = time.perf_counter()
    expired = table.expire_snapshots(retain_max=1, retain_min=1)
    orphans = table.remove_orphan_files(
        older_than_ms=int(time.time() * 1000) + 60_000)
    out["expire_orphan s"] = time.perf_counter() - t0
    out["expired_snapshots"] = len(expired.expired_snapshots)
    after = files_under(path, ".blob")
    out["blob_files"] = {"before_expiry": len(before),
                         "after": len(after)}
    if set(after) != set(sidecars.values()) or \
            any(not os.path.exists(d) for d in sidecars):
        raise AssertionError(f"{name}: after expiry and the orphan clean "
                             f"{len(after)} sidecars on disk, "
                             f"{len(sidecars)} live ({orphans})")

    files = step("$files", lambda: table.system_table("files"),
                 len(sidecars))
    disk = files_under(path, "")
    if sorted(files.column("file_path").to_pylist()) != sorted(sidecars) \
            or any(disk[p] != s for p, s in zip(
                files.column("file_path").to_pylist(),
                files.column("file_size_in_bytes").to_pylist())):
        raise AssertionError(f"{name}: $files differs from the files on "
                             f"disk")
    audit = step("$audit_log", lambda: table.system_table("audit_log"),
                 len(win))
    if set(audit.column("rowkind").to_pylist()) != {"+I"}:
        raise AssertionError(f"{name}: $audit_log kinds "
                             f"{set(audit.column('rowkind').to_pylist())}")
    check_media(f"{name} $audit_log", audit, cols, win, dev)
    out["live_rows"] = len(win)
    return out, table, cols, win


def formats_coverage(work: str, rec: Recorder, dev, scale: int) -> tuple:
    """One table per data-file format (avro, csv, json, mosaic) and a
    parquet table whose level-0 runs are avro, on bench.py's rows: the
    write, a merge-on-read scan, a full compaction and a scan, each read
    held against the oracle; then the avro codec's own rates."""
    import pyarrow as pa

    from paimon_tpu_torch.format import get_format
    from paimon_tpu_torch.fs import LocalFileIO
    from paimon_tpu_torch.table import FileStoreTable

    rows = FT_COV_PER_COMMIT * FT_COV_COMMITS // scale
    rng = np.random.default_rng(7)
    per = rows // FT_COV_COMMITS
    batches = [pa.table({
        "id": pa.array(rng.integers(0, FT_COV_KEYS // scale, per),
                       pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, per), pa.int64()),
        "v2": pa.array(rng.random(per), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, per).astype(np.int32),
                       pa.int32())}) for _ in range(FT_COV_COMMITS)]
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    win = last_writer_oracle(cols["id"])
    out = {"rows": rows}
    tables = {}
    for fmt in FT_FORMATS + ("parquet_level0_avro",):
        opts = {"bucket": "1", "file.format": fmt} if fmt in FT_FORMATS \
            else {"bucket": "1", "file.format.per.level": "0:avro"}
        name = f"ft_{fmt}"
        path = os.path.join(work, name)
        reads = drive_table(path, bigint_schema(opts), batches,
                            lambda what, got: check_rows(what, got, cols,
                                                         win, "id"),
                            rec, device=dev)
        mine = [p for p in rec.phases if p["table"] == name]
        out[name] = {p["phase"]: {"s": p["s"], "rows_per_s": p["rows_per_s"],
                                  "launches": p["launches_plain"]}
                     for p in mine}
        exts = {f.file_name.rsplit(".", 1)[-1]
                for s in FileStoreTable.load(path, device=dev)
                .new_read_builder().new_scan().plan().splits
                for f in s.data_files}
        want = {"parquet"} if fmt == "parquet_level0_avro" else {fmt}
        if exts != want:
            raise AssertionError(f"{name}: data files {exts} after the "
                                 f"compaction, not {want}")
        tables[fmt] = FileStoreTable.load(path, device=dev)
        del reads
    # the avro row codec alone on one commit's rows (pure Python; the
    # reference's codec, byte for byte)
    fio = LocalFileIO()
    avro = get_format("avro")
    apath = os.path.join(work, "codec.avro")
    t0 = time.perf_counter()
    avro.create_writer("zstd").write(fio, apath, batches[0])
    t1 = time.perf_counter()
    back = avro.create_reader().read(fio, apath)
    t2 = time.perf_counter()
    if back.num_rows != per or not np.array_equal(
            back.column("id").to_numpy(), batches[0].column("id")
            .to_numpy()):
        raise AssertionError("the avro codec's round trip differs")
    out["avro_codec"] = {"rows": per, "write_rows_per_s": per / (t1 - t0),
                         "read_rows_per_s": per / (t2 - t1),
                         "bytes": os.path.getsize(apath)}
    log(f"  avro codec on {per} rows: write {per / (t1 - t0):,.0f} rows/s, "
        f"read {per / (t2 - t1):,.0f} rows/s")
    return out, tables, cols, win


def check_system_tables(what: str, table, rows: int, checks: dict,
                        skip=()) -> dict:
    """Every system table (but `skip`, read before) read once, each
    dropped after its check: the row counts the table's own metadata
    gives where it gives one, and `checks[name](table)` where given.
    Returns {name: {"rows": rows, "s": seconds to read}}."""
    from paimon_tpu_torch.table.system import SYSTEM_TABLES

    n_files = len(table.new_scan().read_entries(table.latest_snapshot()))
    want = {"snapshots": len(list(table.snapshot_manager.snapshots())),
            "files": n_files, "file_key_ranges": n_files,
            "audit_log": rows, "read_optimized": rows, "binlog": rows,
            "options": len(table.schema.options)}
    got = {}
    for name in sorted(set(SYSTEM_TABLES) - set(skip)):
        t0 = time.perf_counter()
        t = table.system_table(name)
        got[name] = {"rows": t.num_rows, "s": time.perf_counter() - t0}
        if name in want and t.num_rows != want[name]:
            raise AssertionError(f"{what}: ${name} has {t.num_rows} rows, "
                                 f"expected {want[name]}")
        if name in checks:
            checks[name](t)
        del t
    return got


def surfaces_coverage(work: str, dev, media, formats, scale: int) -> dict:
    """The table surfaces over the new formats: every system table on
    blob_media_2G and on the avro table ($read_optimized after the full
    compaction equal to the oracle, $snapshots one row a snapshot),
    ANALYZE and $statistics against the oracle, $row_tracking on a
    row-tracked table, FormatTables over csv, json and parquet
    directories with dt= partitions and an ObjectTable over the media
    table's directory."""
    import pyarrow as pa

    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.table.format_table import FormatTable
    from paimon_tpu_torch.table.object_table import ObjectTable

    out = {}
    m_table, m_cols, m_win = media
    f_tables, f_cols, f_win = formats
    avro = f_tables["avro"]

    def snapshots_of(table):
        def check(t):
            if t.column("snapshot_id").to_pylist() != \
                    [s.id for s in table.snapshot_manager.snapshots()]:
                raise AssertionError("$snapshots differs from the "
                                     "snapshots")
        return check
    t0 = time.perf_counter()
    out["blob_media_2G"] = check_system_tables(
        "blob_media_2G", m_table, len(m_win), {
            "snapshots": snapshots_of(m_table),
            "read_optimized": lambda t: check_media(
                "blob_media_2G $read_optimized", t, m_cols, m_win, dev)},
        skip=("files", "audit_log"))
    out["blob_media_2G s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ft_avro"] = check_system_tables("ft_avro", avro, len(f_win), {
        "snapshots": snapshots_of(avro),
        "read_optimized": lambda t: check_rows(
            "ft_avro $read_optimized", t, f_cols, f_win, "id"),
        "audit_log": lambda t: check_rows(
            "ft_avro $audit_log", t.drop_columns(["rowkind"]), f_cols,
            f_win, "id")})
    out["ft_avro s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for what, table, cols, win in (("blob_media_2G", m_table, m_cols, m_win),
                                   ("ft_avro", avro, f_cols, f_win)):
        t1 = time.perf_counter()
        if table.analyze() is None:
            raise AssertionError(f"{what}: ANALYZE committed nothing")
        out[f"analyze {what} s"] = time.perf_counter() - t1
        st = table.system_table("statistics").to_pylist()[0]
        stats = table.statistics()
        if st["merged_record_count"] != len(win) or \
                stats["colStats"]["id"]["distinctCount"] != len(win):
            raise AssertionError(f"{what}: $statistics {st} against "
                                 f"{len(win)} rows")
    out["analyze s"] = time.perf_counter() - t0

    # $row_tracking: contiguous row-id ranges over a row-tracked table
    t0 = time.perf_counter()
    tracked = FileStoreTable.create(
        os.path.join(work, "ft_tracked"), append_schema({
            "bucket": "-1", "row-tracking.enabled": "true"}), device=dev)
    n = FT_TRACKED_ROWS // scale
    for b in bigint_batches(n, runs=4):
        wb = tracked.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(b)
            wb.new_commit().commit(w.prepare_commit())
    rt = tracked.system_table("row_tracking").sort_by("first_row_id")
    firsts = rt.column("first_row_id").to_pylist()
    nexts = rt.column("next_row_id_after").to_pylist()
    if firsts[0] != 0 or firsts[1:] != nexts[:-1] or nexts[-1] != n:
        raise AssertionError(f"$row_tracking ranges not contiguous: "
                             f"{list(zip(firsts, nexts))}")
    out["row_tracking_files"] = rt.num_rows
    out["row_tracking s"] = time.perf_counter() - t0

    # FormatTables: a plain directory a format, partitioned by dt
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    n = FT_FORMAT_TABLE_ROWS // scale
    data = pa.table({
        "id": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
        "v1": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
        "v2": pa.array(rng.random(n), pa.float64()),
        "v3": pa.array(rng.integers(0, 100, n).astype(np.int32),
                       pa.int32())})
    days = np.array(FT_DAYS)[rng.integers(0, len(FT_DAYS), n)]
    order = [("dt", "ascending"), ("id", "ascending")]
    want = data.append_column("dt", pa.array(days, pa.string())) \
        .sort_by(order)
    for fmt in ("csv", "json", "parquet"):
        ft = FormatTable(os.path.join(work, f"format_{fmt}"), fmt)
        for day in FT_DAYS:
            ft.write(data.filter(pa.array(days == day)),
                     partition={"dt": day})
        got = ft.to_arrow().select(want.column_names).cast(want.schema) \
            .sort_by(order)
        if not got.equals(want):
            raise AssertionError(f"FormatTable {fmt}: rows differ")
        one = ft.to_arrow({"dt": FT_DAYS[1]})
        if one.num_rows != int((days == FT_DAYS[1]).sum()):
            raise AssertionError(f"FormatTable {fmt}: partition read "
                                 f"{one.num_rows} rows")
    out["format_tables s"] = time.perf_counter() - t0

    # an ObjectTable over the media table's directory
    t0 = time.perf_counter()
    listing = ObjectTable(m_table.path).to_arrow()
    prefix = len(m_table.path) + 1
    if dict(zip(listing.column("path").to_pylist(),
                listing.column("length").to_pylist())) != \
            {p[prefix:]: s for p, s in files_under(m_table.path).items()}:
        raise AssertionError("ObjectTable: the listing differs from the "
                             "files on disk")
    out["object_table_files"] = listing.num_rows
    out["object_table s"] = time.perf_counter() - t0
    return out


def formats_types(work: str, rec: Recorder, device="cuda",
                  scale: int = 1) -> dict:
    """Data formats and types on the card (`scale` divides the row
    counts, for a rehearsal).  Returns what the phase reports."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    media, m_table, m_cols, m_win = blob_media(work, rec, dev, scale)
    media["s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    cov, f_tables, f_cols, f_win = formats_coverage(work, rec, dev, scale)
    cov["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {"blob_media_2G": media, "formats_coverage": cov,
           "surfaces_coverage": surfaces_coverage(
               work, dev, (m_table, m_cols, m_win),
               (f_tables, f_cols, f_win), scale)}
    out["surfaces_coverage"]["s"] = time.perf_counter() - t0
    names = {"blob_media_2G"} | {f"ft_{f}" for f in
                                 FT_FORMATS + ("parquet_level0_avro",)}
    mine = [p for p in rec.phases if p["table"] in names]
    out["launches_plain"] = sum(p["launches_plain"] for p in mine)
    out["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    out["launch_shapes"] = sorted(
        [[k[0]] + list(k[1:4]) + [k[4], v]
         for k, v in rec.capture.calls.items() if k[0] in names])
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    shutil.rmtree(m_table.path, ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- the catalog and SQL: catalogs, the SQL front end, procedures, the CLI ---

SQL_INSERTS = 8                  # sql_orders_16M: 8 INSERTs of 2M rows,
SQL_PER_INSERT = 2_000_000       # ids uniform in [0, 8M): about 220 MB of
SQL_KEYS = 8_000_000             # raw rows a bucket, 2 buckets
SQL_V1_RANGE = 1 << 32           # v1 in [0, 2^32): the sums of 16M rows
#                                  stay inside BIGINT
SQL_RANGE = 65_536               # the range query's ids
SQL_MERGE_ROWS = 1_000_000       # MERGE source: distinct ids uniform in
SQL_MERGE_KEYS = 16_000_000      # [0, 16M), so ~43% match a live row
SQL_REGIONS = 100                # shop.regions: one row a v3 value
SQL_RETAIN = 3                   # sys.expire_snapshots' retain_max; the
SQL_RETAIN_MIN = 10              # snapshot.num-retained.min default keeps
#                                  the newest 10
SQL_COV_ROWS = 1 << 16           # sql_coverage's migrated directory, and
#                                  each of its aggregation table's inserts
#                                  (2^18 until the stream phase came, 2^17
#                                  until the search phase)
SQL_COV_CAT_ROWS = 1 << 16       # each JDBC and REST catalog's table


class SqlOracle:
    """sql_orders_16M by numpy alone, dense over the id range: per id
    whether it is live and its v1, v2, v3."""

    def __init__(self, capacity: int):
        self.live = np.zeros(capacity, bool)
        self.v1 = np.zeros(capacity, np.int64)
        self.v2 = np.zeros(capacity, np.float64)
        self.v3 = np.zeros(capacity, np.int32)

    def upsert(self, ids, v1, v2, v3=None) -> None:
        """One statement's upserts: the last row of an id wins (v3 kept
        where not given)."""
        at = np.full(len(self.live), -1, np.int64)
        np.maximum.at(at, ids, np.arange(len(ids)))
        u = np.flatnonzero(at >= 0)
        last = at[u]
        self.live[u] = True
        self.v1[u] = v1[last]
        self.v2[u] = v2[last]
        if v3 is not None:
            self.v3[u] = v3[last]

    def ids(self) -> np.ndarray:
        return np.flatnonzero(self.live)

    def count_sum(self) -> list:
        return [{"n": int(self.live.sum()),
                 "s": int(self.v1[self.live].sum())}]

    def by_v3(self) -> list:
        live = self.live
        v3, v1, v2 = self.v3[live], self.v1[live], self.v2[live]
        n = np.bincount(v3, minlength=SQL_REGIONS)
        s = np.zeros(SQL_REGIONS, np.int64)
        np.add.at(s, v3, v1)
        m = np.full(SQL_REGIONS, -np.inf)
        np.maximum.at(m, v3, v2)
        return [{"v3": int(k), "n": int(n[k]), "s": int(s[k]),
                 "m": float(m[k])} for k in np.flatnonzero(n)]

    def check(self, what: str, got, lo: int = 0, hi=None) -> None:
        """`got` (id, v1, v2, v3) is exactly the live rows with ids in
        [lo, hi), in any order."""
        hi = len(self.live) if hi is None else hi
        ids = got.column("id").combine_chunks().to_numpy()
        want = int(self.live[lo:hi].sum())
        if len(ids) != want:
            raise AssertionError(f"{what}: {len(ids)} rows, oracle {want}")
        if len(ids) and (ids.min() < lo or ids.max() >= hi or
                         not self.live[ids].all()):
            raise AssertionError(f"{what}: an id the oracle does not hold")
        seen = np.zeros(hi - lo, bool)
        seen[ids - lo] = True
        if int(seen.sum()) != len(ids):
            raise AssertionError(f"{what}: an id read twice")
        for c in ("v1", "v2", "v3"):
            col = got.column(c).combine_chunks()
            if col.null_count or not np.array_equal(
                    col.to_numpy(), getattr(self, c)[ids]):
                raise AssertionError(f"{what}: column {c} differs from "
                                     f"the oracle")


def sql_batch(rng, n: int, id_range: int, unique: bool = False):
    """bench.py's columns for SQL: ids uniform in [0, id_range) (distinct
    with `unique`), v1 uniform in [0, 2^32), v2 in [0, 1), v3 in
    [0, 100)."""
    import pyarrow as pa
    ids = rng.choice(id_range, n, replace=False) if unique \
        else rng.integers(0, id_range, n)
    return pa.table({
        "id": pa.array(ids, pa.int64()),
        "v1": pa.array(rng.integers(0, SQL_V1_RANGE, n), pa.int64()),
        "v2": pa.array(rng.random(n), pa.float64()),
        "v3": pa.array(rng.integers(0, SQL_REGIONS, n).astype(np.int32))})


def sql_regions():
    """shop.regions' rows: v3 0..99, a name of ten, a weight."""
    import pyarrow as pa
    rng = np.random.default_rng(7)
    return pa.table({
        "v3": pa.array(np.arange(SQL_REGIONS, dtype=np.int32)),
        "name": pa.array([f"region-{k % 10}" for k in range(SQL_REGIONS)]),
        "weight": pa.array(rng.random(SQL_REGIONS))})


def columns_of(batch) -> tuple:
    return tuple(batch.column(c).to_numpy() for c in ("id", "v1", "v2",
                                                       "v3"))


def same_result(what: str, got, want: list) -> None:
    """A query's rows equal the oracle's, in order (floats exactly)."""
    rows = got.to_pylist()
    if rows != want:
        raise AssertionError(f"{what}: {rows[:3]} ... ({len(rows)} rows), "
                             f"oracle {want[:3]} ... ({len(want)} rows)")


class CliRun:
    """`python -m paimon_tpu_torch --warehouse W -f json ...`, started in
    the background from the checkout's root: on the card (no --device)
    unless `dev` is the CPU (a rehearsal).  A thread of its own waits
    for it, so its wall time is known whenever it is read."""

    def __init__(self, warehouse: str, dev, *argv):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        device = ["--device", "cpu"] if dev.type == "cpu" else []
        self.argv = argv
        self.t0 = time.perf_counter()
        self.s = None
        self.out = self.err = ""
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paimon_tpu_torch", "--warehouse",
             warehouse, *device, "-f", "json", *argv], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        self.out, self.err = self.proc.communicate()
        self.s = time.perf_counter() - self.t0

    def rows(self, timeout: float = 300.0) -> list:
        """The JSON rows it printed; raises unless it exited 0."""
        self.thread.join(timeout)
        self.stop()
        if self.proc.returncode != 0:
            raise AssertionError(f"the CLI's {self.argv[0]}: exit "
                                 f"{self.proc.returncode}: "
                                 f"{self.err.strip()[-500:]}")
        return [json.loads(line) for line in self.out.splitlines()
                if line.strip()]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.thread.join()


def sql_orders(work: str, rec: Recorder, dev, scale: int) -> tuple:
    """sql_orders_16M through create_catalog and SQLContext: returns what
    it reports, its catalog, its oracle and the CLI runs started on its
    final rows."""

    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.sql import SQLContext

    name = f"sql_orders_{16 // scale}M" if scale <= 16 else "sql_orders"
    per, keys = SQL_PER_INSERT // scale, SQL_KEYS // scale
    merge_rows, merge_keys = SQL_MERGE_ROWS // scale, SQL_MERGE_KEYS // scale
    wh = os.path.join(work, "sql_wh")
    rng = np.random.default_rng(7)
    out: dict = {"rows": SQL_INSERTS * per}
    steps: dict = {}

    def step(what, rows, fn):
        t0 = time.perf_counter()
        res = rec.run(name, what, rows, dev, fn)
        steps[what] = time.perf_counter() - t0
        return res

    catalog = create_catalog({"warehouse": wh}, device=dev)
    ctx = SQLContext(catalog)
    oracle = SqlOracle(merge_keys)

    def ddl():
        ctx.sql("CREATE DATABASE shop")
        ctx.sql("CREATE TABLE shop.orders (id BIGINT NOT NULL, v1 BIGINT, "
                "v2 DOUBLE, v3 INT, PRIMARY KEY (id) NOT ENFORCED) WITH ("
                "'bucket' = '2', 'write-only' = 'true')")
        ctx.sql("CREATE TABLE shop.regions (v3 INT NOT NULL, name STRING, "
                "weight DOUBLE, PRIMARY KEY (v3) NOT ENFORCED) WITH ("
                "'bucket' = '1')")
        ctx.register("regions_src", sql_regions())
        ctx.sql("INSERT INTO shop.regions SELECT * FROM regions_src")
    step("create database and tables", SQL_REGIONS, ddl)

    t0 = time.perf_counter()
    batches = [sql_batch(rng, per, keys) for _ in range(SQL_INSERTS)]
    log(f"  {name}: {SQL_INSERTS} batches of {per} rows made in "
        f"{time.perf_counter() - t0:.2f} s")

    def insert():
        for b in batches:
            ctx.register("staged", b)
            ctx.sql("INSERT INTO shop.orders SELECT * FROM staged")
    step(f"insert x{SQL_INSERTS}", SQL_INSERTS * per, insert)
    t0 = time.perf_counter()
    oracle.upsert(*(np.concatenate(c) for c in
                    zip(*(columns_of(b) for b in batches))))
    ctx.register("staged", batches[0].slice(0, 0))
    del batches
    log(f"  {name}: oracle of the inserts in "
        f"{time.perf_counter() - t0:.2f} s")
    live = int(oracle.live.sum())

    q = "SELECT count(*) AS n FROM shop.orders"
    same_result(f"{name} count(*)", step("count(*)", live,
                                         lambda: ctx.sql(q)),
                [{"n": live}])
    lo = keys // 2
    got = step("range select", SQL_RANGE, lambda: ctx.sql(
        f"SELECT * FROM shop.orders WHERE id BETWEEN {lo} AND "
        f"{lo + SQL_RANGE - 1}"))
    oracle.check(f"{name} range select", got, lo, lo + SQL_RANGE)
    got = step("group by v3", live, lambda: ctx.sql(
        "SELECT v3, count(*) AS n, sum(v1) AS s, max(v2) AS m FROM "
        "shop.orders GROUP BY v3 ORDER BY v3"))
    same_result(f"{name} group by v3", got, oracle.by_v3())
    got = step("star join", live, lambda: ctx.sql(
        "SELECT r.name, count(*) AS n, sum(o.v1) AS s FROM shop.orders o "
        "JOIN shop.regions r ON o.v3 = r.v3 GROUP BY r.name"))
    want: dict = {}
    for row in oracle.by_v3():
        acc = want.setdefault(f"region-{row['v3'] % 10}",
                              {"n": 0, "s": 0})
        acc["n"] += row["n"]
        acc["s"] += row["s"]
    same_result(f"{name} star join",
                got.sort_by("name"),
                [{"name": k, **v} for k, v in sorted(want.items())])

    def read_check(what):
        got = step(f"read after {what}", int(oracle.live.sum()),
                   lambda: ctx.sql("SELECT * FROM shop.orders"))
        oracle.check(f"{name} read after {what}", got)

    hit = oracle.live & (oracle.v3 == 42)
    out["updated"] = int(hit.sum())
    res = step("update v3 = 42", out["updated"], lambda: ctx.sql(
        "UPDATE shop.orders SET v1 = v1 + 1 WHERE v3 = 42"))
    same_result(f"{name} update", res, [{"result": f"{out['updated']} rows "
                                                   f"updated"}])
    oracle.v1[hit] += 1
    read_check("update")

    cut = 80_000 // scale
    out["deleted"] = int(oracle.live[:cut].sum())
    res = step("delete id < cut", out["deleted"], lambda: ctx.sql(
        f"DELETE FROM shop.orders WHERE id < {cut}"))
    same_result(f"{name} delete", res, [{"result": f"{out['deleted']} rows "
                                                   f"deleted"}])
    oracle.live[:cut] = False
    read_check("delete")

    src = sql_batch(rng, merge_rows, merge_keys, unique=True)
    ids, v1, v2, v3 = columns_of(src)
    matched = oracle.live[ids]
    out["merge_matched"] = int(matched.sum())
    ctx.register("merge_src", src)
    res = step("merge into", merge_rows, lambda: ctx.sql(
        "MERGE INTO shop.orders t USING merge_src s ON t.id = s.id "
        "WHEN MATCHED THEN UPDATE SET v1 = s.v1, v2 = s.v2 "
        "WHEN NOT MATCHED THEN INSERT VALUES (s.id, s.v1, s.v2, s.v3)"))
    same_result(f"{name} merge", res, [{"result": f"{merge_rows} rows "
                                                  f"merged"}])
    oracle.upsert(ids[matched], v1[matched], v2[matched])
    oracle.upsert(ids[~matched], v1[~matched], v2[~matched], v3[~matched])
    ctx.register("merge_src", src.slice(0, 0))
    del src, ids, v1, v2, v3
    # the rows are final: the CLI's processes start here and answer while
    # the steps below (which keep every row as it is) and sql_coverage
    # run; their snapshot may be this one or a later one
    before = oracle.count_sum()
    q = "SELECT count(*) AS n, sum(v1) AS s FROM {}"
    cli = (CliRun(wh, dev, "sql", q.format("shop.orders")),
           CliRun(wh, dev, "table", "read", "shop.regions"), before)
    read_check("merge")

    step("create_tag", 0, lambda: ctx.sql(
        "CALL sys.create_tag('shop.orders', 'pre_compact')"))
    res = step("compact", before[0]["n"], lambda: ctx.sql(
        "CALL sys.compact('shop.orders', true)"))
    if not res.column("result")[0].as_py().startswith("snapshot "):
        raise AssertionError(f"{name} compact: {res.to_pylist()}")
    got = step("time travel to the tag", before[0]["n"], lambda: ctx.sql(
        "SELECT count(*) AS n, sum(v1) AS s FROM shop.orders VERSION AS OF "
        "'pre_compact'"))
    same_result(f"{name} time travel", got, before)
    latest = catalog.get_table("shop.orders").latest_snapshot().id
    snaps = step("$snapshots", 0, lambda: ctx.sql(
        "SELECT snapshot_id, commit_kind FROM shop.orders$snapshots"))
    if sorted(snaps.column("snapshot_id").to_pylist()) != \
            list(range(1, latest + 1)):
        raise AssertionError(f"{name} $snapshots: "
                             f"{snaps.column('snapshot_id').to_pylist()}, "
                             f"latest {latest}")
    out["snapshots"] = latest
    res = step("expire_snapshots", 0, lambda: ctx.sql(
        f"CALL sys.expire_snapshots('shop.orders', {SQL_RETAIN})"))
    kept = max(SQL_RETAIN, SQL_RETAIN_MIN)
    left = ctx.sql("SELECT snapshot_id FROM shop.orders$snapshots")
    if sorted(left.column("snapshot_id").to_pylist()) != \
            list(range(max(latest - kept, 0) + 1, latest + 1)):
        raise AssertionError(f"{name} expire_snapshots: {res.to_pylist()}, "
                             f"left {left.to_pylist()}")
    out["expired"] = max(latest - kept, 0)

    ctx.sql("CREATE DATABASE backup")
    step("clone", before[0]["n"], lambda: ctx.sql(
        "CALL sys.clone('shop.orders', 'backup.orders')"))
    got = step("count and sum of the clone", before[0]["n"],
               lambda: ctx.sql(q.format("backup.orders")))
    same_result(f"{name} clone", got, before)
    got = step("sys.all_tables", 0, lambda: ctx.sql(
        "SELECT database_name, table_name, record_count FROM sys.all_tables "
        "ORDER BY database_name, table_name"))
    same_result(f"{name} sys.all_tables", got, [
        {"database_name": "backup", "table_name": "orders",
         "record_count": before[0]["n"]},
        {"database_name": "shop", "table_name": "orders",
         "record_count": before[0]["n"]},
        {"database_name": "shop", "table_name": "regions",
         "record_count": SQL_REGIONS}])
    out["steps_s"] = steps
    return out, catalog, oracle, cli


def sql_coverage(work: str, rec: Recorder, dev, scale: int, catalog,
                 cli) -> dict:
    """sql_coverage: migrate, an aggregation table made by DDL, INSERT
    OVERWRITE, a view, a SQL function and a window query, the JDBC and
    REST catalogs, a privileged user, and the CLI's answers."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.catalog.privilege import (
        Privilege, PrivilegedCatalog, PrivilegeError, PrivilegeManager,
    )
    from paimon_tpu_torch.catalog.rest import RESTCatalogServer
    from paimon_tpu_torch.sql import SQLContext

    name = "sql_coverage"
    rows = max(SQL_COV_ROWS // scale, 1024)
    cat_rows = max(SQL_COV_CAT_ROWS // scale, 1024)
    rng = np.random.default_rng(7)
    ctx = SQLContext(catalog)
    out: dict = {}
    steps: dict = {}

    def step(what, n, fn):
        t0 = time.perf_counter()
        res = rec.run(name, what, n, dev, fn)
        steps[what] = time.perf_counter() - t0
        return res

    ctx.sql("CREATE DATABASE cov")
    # a hive-style parquet directory, 4 dt= partitions, migrated in place
    hive = os.path.join(work, "hive_orders")
    parts = []
    for k in range(4):
        d = os.path.join(hive, f"dt=2026-01-0{k + 1}")
        os.makedirs(d)
        b = sql_batch(rng, rows // 4, rows, unique=True)
        b = b.set_column(0, "id", pa.array(
            np.arange(k * rows // 4, (k + 1) * rows // 4), pa.int64()))
        pq.write_table(b, os.path.join(d, "part-0.parquet"))
        parts.append(b.append_column("dt", pa.array(
            [f"2026-01-0{k + 1}"] * b.num_rows)))
    step("migrate_table", rows, lambda: ctx.sql(
        f"CALL sys.migrate_table('{hive}', 'cov.migrated')"))
    got = ctx.sql("SELECT * FROM cov.migrated ORDER BY id")
    want = pa.concat_tables(parts)
    if sorted(got.column_names) != sorted(want.column_names) or not all(
            got.column(c).combine_chunks().equals(
                want.column(c).combine_chunks()) for c in want.column_names):
        raise AssertionError(f"{name}: the migrated table differs from its "
                             f"files")

    # an aggregation table created by DDL: 4 inserts, read, compact, read
    ctx.sql("CREATE TABLE cov.agg (id BIGINT NOT NULL, v1 BIGINT, v2 DOUBLE, "
            "v3 INT, PRIMARY KEY (id) NOT ENFORCED) WITH ('bucket' = '1', "
            "'write-only' = 'true', 'merge-engine' = 'aggregation', "
            "'fields.v1.aggregate-function' = 'sum', "
            "'fields.v2.aggregate-function' = 'max', "
            "'fields.v3.aggregate-function' = 'max')")
    batches = [sql_batch(rng, rows, rows) for _ in range(4)]

    def agg_insert():
        for b in batches:
            ctx.register("staged", b)
            ctx.sql("INSERT INTO cov.agg SELECT * FROM staged")
    step("aggregation insert x4", 4 * rows, agg_insert)
    agg_want = agg_oracle({c: np.concatenate([b.column(c).to_numpy()
                                              for b in batches])
                           for c in ("id", "v1", "v2", "v3")})
    got = step("aggregation read", 4 * rows,
               lambda: ctx.sql("SELECT * FROM cov.agg"))
    check_agg(f"{name} aggregation read", got, agg_want)
    step("aggregation compact", 4 * rows, lambda: ctx.sql(
        "CALL sys.compact('cov.agg', true)"))
    check_agg(f"{name} aggregation read after compaction",
              ctx.sql("SELECT * FROM cov.agg"), agg_want)

    # INSERT OVERWRITE, a view, a SQL function, a window
    cov = SQLContext(catalog, database="cov")
    kept = sql_batch(rng, 2048, 8192, unique=True)

    def small():
        cov.sql("CREATE TABLE small (id BIGINT NOT NULL, v1 BIGINT, "
                "v2 DOUBLE, v3 INT, PRIMARY KEY (id) NOT ENFORCED) WITH ("
                "'bucket' = '2')")
        cov.register("staged", sql_batch(rng, 4096, 8192))
        cov.sql("INSERT INTO small SELECT * FROM staged")
        cov.register("staged", kept)
        cov.sql("INSERT OVERWRITE small SELECT * FROM staged")
        cov.sql("CREATE VIEW low AS SELECT id, v1, v2, v3 FROM small "
                "WHERE v3 < 50")
        cov.sql("CREATE FUNCTION scaled (x DOUBLE, n INT) RETURNS DOUBLE "
                "AS 'x * n'")
        return (cov.sql("SELECT id, scaled(v2, v3) AS w FROM low "
                        "ORDER BY id"),
                cov.sql("SELECT id, v3, row_number() OVER (PARTITION BY v3 "
                        "ORDER BY id) AS rn FROM small ORDER BY v3, id"))
    via_view, window = step("overwrite, view, function, window",
                            kept.num_rows, small)
    k_ids, _, k_v2, k_v3 = columns_of(kept)
    low = np.flatnonzero(k_v3 < 50)
    low = low[np.argsort(k_ids[low])]
    same_result(f"{name} view and function", via_view,
                [{"id": int(i), "w": float(w)} for i, w in
                 zip(k_ids[low], k_v2[low] * k_v3[low])])
    order = np.lexsort((k_ids, k_v3))
    v3s = k_v3[order]
    starts = np.flatnonzero(np.r_[True, v3s[1:] != v3s[:-1]])
    rank = np.arange(len(order)) - np.repeat(
        starts, np.diff(np.r_[starts, len(order)])) + 1
    same_result(f"{name} window", window,
                [{"id": int(i), "v3": int(v), "rn": int(r)}
                 for i, v, r in zip(k_ids[order], v3s, rank)])

    # the JDBC (sqlite) and REST catalogs on loopback
    def jdbc():
        cat = create_catalog({"metastore": "jdbc",
                              "uri": os.path.join(work, "catalog.db"),
                              "warehouse": os.path.join(work, "jdbc_wh")},
                             device=dev)
        try:
            return catalog_round_trip("jdbc", cat, rng, cat_rows)
        finally:
            cat.close()
    step("jdbc catalog", cat_rows, jdbc)

    def rest():
        backing = create_catalog({"warehouse": os.path.join(work,
                                                            "rest_wh")},
                                 device=dev)
        server = RESTCatalogServer(backing, token="chip-smoke").start()
        try:
            client = create_catalog({"metastore": "rest", "uri": server.uri,
                                     "token": "chip-smoke"}, device=dev)
            return catalog_round_trip("rest", client, rng, cat_rows)
        finally:
            server.stop()
    step("rest catalog", cat_rows, rest)

    # a user granted SELECT only: reads, and is refused an INSERT
    pm = PrivilegeManager(catalog.file_io, catalog.warehouse)
    pm.init("root-pw")
    pm.create_user("reader", "reader-pw")
    pm.grant("reader", Privilege.SELECT, "cov.small")
    reader = SQLContext(PrivilegedCatalog(catalog, "reader", "reader-pw"))
    if reader.sql("SELECT count(*) AS n FROM cov.small").to_pylist() != \
            [{"n": kept.num_rows}]:
        raise AssertionError(f"{name}: the privileged read differs")
    try:
        reader.sql("INSERT INTO cov.small VALUES (1, 1, 1.0, 1)")
    except PrivilegeError:
        out["insert_refused"] = True
    else:
        raise AssertionError(f"{name}: a user without INSERT inserted")

    # the CLI processes started on sql_orders' final rows
    cli_count, cli_read, before = cli
    t0 = time.perf_counter()
    got = cli_count.rows()
    if got != before:
        raise AssertionError(f"the CLI's sql: {got}, oracle {before}")
    got = cli_read.rows()
    if sorted(got, key=lambda r: r["v3"]) != sql_regions().to_pylist():
        raise AssertionError("the CLI's table read differs from "
                             "shop.regions")
    steps["cli wait"] = time.perf_counter() - t0
    out["cli"] = {"sql_s": cli_count.s, "table_read_s": cli_read.s,
                  "equal": True}
    out["steps_s"] = steps
    return out


def catalog_round_trip(kind: str, catalog, rng, rows: int) -> int:
    """A table created, filled and read back through SQL on `catalog`."""
    from paimon_tpu_torch.sql import SQLContext
    ctx = SQLContext(catalog)
    ctx.sql("CREATE DATABASE db")
    ctx.sql("CREATE TABLE db.t (id BIGINT NOT NULL, v1 BIGINT, v2 DOUBLE, "
            "v3 INT, PRIMARY KEY (id) NOT ENFORCED) WITH ('bucket' = '2')")
    b = sql_batch(rng, rows, 4 * rows, unique=True)
    ctx.register("staged", b)
    ctx.sql("INSERT INTO db.t SELECT * FROM staged")
    got = ctx.sql("SELECT * FROM db.t ORDER BY id")
    want = b.sort_by("id")
    if got.column_names != want.column_names or not all(
            got.column(c).combine_chunks().equals(
                want.column(c).combine_chunks()) for c in want.column_names):
        raise AssertionError(f"the {kind} catalog's table differs")
    if catalog.get_table("db.t").device != catalog.device:
        raise AssertionError(f"the {kind} catalog's table is off its device")
    return rows


def catalog_sql(work: str, rec: Recorder, device="cuda",
                scale: int = 1) -> dict:
    """The catalog and SQL on the card (`scale` divides the row counts,
    for a rehearsal): sql_orders_16M, then sql_coverage.  Returns what
    the phase reports."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    orders, catalog, oracle, cli = sql_orders(work, rec, dev, scale)
    orders["s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    try:
        cov = sql_coverage(work, rec, dev, scale, catalog, cli)
    finally:
        for run in cli[:2]:
            run.stop()
    cov["s"] = time.perf_counter() - t0
    name = next(p["table"] for p in rec.phases
                if p["table"].startswith("sql_orders"))
    out = {name: orders, "sql_coverage": cov}
    for table in (name, "sql_coverage"):
        mine = [p for p in rec.phases if p["table"] == table]
        out[table]["launches_plain"] = sum(p["launches_plain"] for p in mine)
        out[table]["launches_ovc"] = sum(p["launches_ovc"] for p in mine)
    if device != "cpu" and (out[name]["launches_plain"] == 0 or
                            out["sql_coverage"]["launches_ovc"] == 0):
        raise AssertionError(f"catalog_sql: K1 in {name} "
                             f"{out[name]['launches_plain']} times, K2 in "
                             f"sql_coverage "
                             f"{out['sql_coverage']['launches_ovc']} times")
    out["launch_shapes"] = sorted(
        [[k[0]] + list(k[1:4]) + [k[4], v]
         for k, v in rec.capture.calls.items()
         if k[0] in (name, "sql_coverage")])
    mine = [p for p in rec.phases if p["table"] in (name, "sql_coverage")]
    peaks = [p["peak_gib"] for p in mine if p["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    shutil.rmtree(os.path.join(work, "sql_wh"), ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- the serving plane: point lookups and the one-replica query service ------

SERVE_ROWS = 312_500             # cut from 10M, then 5M, 2.5M, 1.25M,
                                 # 625K
                                 # (script time)
SERVE_COMMITS = 4
SERVE_BUCKETS = 4
SERVE_BATCH = 8                  # keys of a point-get request
SERVE_WRITER_ROWS = 50_000       # 100K until the formats phase came
SERVE_SCAN_LIMIT = 50_000        # the /scan after the compaction (every
#                                  live row until the formats phase came)
SERVE_WRITER_BATCH = 10_000


def serving_batches(rows: int, commits: int = SERVE_COMMITS, seed: int = 11):
    """benchmarks/serve_bench.py build_serving_table's commits: `commits`
    batches of rows / commits ids uniform in [0, rows), v uniform in
    [0, 1), name "c<commit>-<id % 997>", from `seed`."""
    import pyarrow as pa
    import pyarrow.compute as pc
    rng = np.random.default_rng(seed)
    per = rows // commits
    out = []
    for c in range(commits):
        ids = rng.integers(0, rows, per)
        out.append(pa.table({
            "id": pa.array(ids, pa.int64()),
            "v": pa.array(rng.random(per), pa.float64()),
            "name": pc.binary_join_element_wise(
                pa.scalar(f"c{c}"), pc.cast(pa.array(ids % 997),
                                            pa.string()), "-")}))
    return out


class ServeOracle:
    """The served table by numpy alone, dense over the id range: per id
    whether it is live, its v (the last writer's, or the per-id sum
    under aggregation) and the tag of the last writer's name ("c<tag>-"
    for a commit of serving_batches, "w<tag - 100>-" for a serving
    writer batch)."""

    def __init__(self, rows: int, batches, summed: bool = False):
        self.rows = rows
        self.live = np.zeros(rows, bool)
        self.v = np.zeros(rows, np.float64)
        self.tag = np.zeros(rows, np.int16)
        for c, b in enumerate(batches):
            ids = b.column("id").to_numpy()
            v = b.column("v").to_numpy()
            if summed:
                self.v += np.bincount(ids, weights=v, minlength=rows)
                self.live[ids] = True
                last = np.unique(ids[::-1], return_index=True)[1]
                self.tag[ids[::-1][last]] = c
            else:
                self.upsert(ids, v, c)

    def upsert(self, ids, v, tag: int) -> None:
        # within a batch the last occurrence of an id wins: each id's
        # largest position, scattered by id
        last = np.full(self.rows, -1, np.int64)
        np.maximum.at(last, ids, np.arange(len(ids)))
        keep = last[last >= 0]
        self.live[ids[keep]] = True
        self.v[ids[keep]] = v[keep]
        self.tag[ids[keep]] = tag

    def name(self, i: int) -> str:
        t = int(self.tag[i])
        return f"c{t}-{i % 997}" if t < 100 else f"w{t - 100}-{i % 997}"

    def check(self, what: str, ids, rows, rtol: float = 0.0) -> None:
        """Every answer of a lookup batch: None for a dead id, else the
        row (v exact, or within rtol under aggregation)."""
        for i, row in zip(ids, rows):
            i = int(i)
            if not self.live[i]:
                if row is not None:
                    raise AssertionError(f"{what}: id {i} is not live, "
                                         f"got {row}")
                continue
            want_v = float(self.v[i])
            if row is None or row["id"] != i or \
                    row["name"] != self.name(i) or not (
                        row["v"] == want_v if rtol == 0.0 else
                        abs(row["v"] - want_v) <= rtol * abs(want_v)):
                raise AssertionError(f"{what}: id {i}: got {row}, want "
                                     f"v={want_v!r} name={self.name(i)}")

    def check_scan(self, what: str, rows, complete: bool = False) -> None:
        """Scanned rows, vectorized: distinct live ids, each row exactly
        the oracle's (`complete`: every live id)."""
        n = len(rows)
        ids = np.fromiter((r["id"] for r in rows), np.int64, n)
        v = np.fromiter((r["v"] for r in rows), np.float64, n)
        if len(np.unique(ids)) != n or not self.live[ids].all():
            raise AssertionError(f"{what}: an id repeats or is not live")
        if complete and n != int(self.live.sum()):
            raise AssertionError(f"{what}: {n} rows, oracle "
                                 f"{int(self.live.sum())}")
        tags = self.tag[ids].astype(np.int64)
        prefix = np.where(tags < 100, np.char.add("c", tags.astype(str)),
                          np.char.add("w", (tags - 100).astype(str)))
        names = np.char.add(np.char.add(prefix, "-"),
                            (ids % 997).astype(str))
        if not np.array_equal(v, self.v[ids]) or \
                [r["name"] for r in rows] != names.tolist():
            raise AssertionError(f"{what}: a row differs from the oracle")


def pct(vals, p: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(p / 100 * len(vals)))] if vals \
        else 0.0


def client_load(server, oracle: ServeOracle, clients: int, seconds: float,
                scan_share: float, what: str, rtol: float = 0.0) -> dict:
    """`clients` keep-alive client threads for `seconds`: point gets of
    SERVE_BATCH keys uniform over the id range, and scan(limit=100) with
    probability `scan_share`; every answer kept and held against the
    oracle after the window (a 5xx or any other error fails)."""
    from paimon_tpu_torch.service import KvQueryClient, ServiceBusyError
    stop = threading.Event()
    lock = threading.Lock()
    got = {"lookups": [], "scans": [], "lat": [], "busy": 0, "errors": []}

    def worker(seed):
        r = np.random.default_rng(1000 + seed)
        mine = {"lookups": [], "scans": [], "lat": [], "busy": 0}
        try:
            with KvQueryClient(address=server.address,
                               tenant=f"t{seed % 8}") as c:
                while not stop.is_set():
                    try:
                        if r.random() >= scan_share:
                            ids = r.integers(0, oracle.rows, SERVE_BATCH)
                            t1 = time.perf_counter()
                            rows = c.lookup([{"id": int(i)} for i in ids])
                            mine["lat"].append(
                                (time.perf_counter() - t1) * 1000.0)
                            mine["lookups"].append((ids, rows))
                        else:
                            mine["scans"].append(c.scan(limit=100))
                    except ServiceBusyError:
                        mine["busy"] += 1
                        time.sleep(0.002)
        except Exception as e:      # noqa: BLE001 -- reported, then raised
            with lock:
                got["errors"].append(repr(e))
        with lock:
            for k in ("lookups", "scans", "lat"):
                got[k].extend(mine[k])
            got["busy"] += mine["busy"]

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    counters0 = lookup_counters()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    elapsed = time.perf_counter() - t0
    if got["errors"] or any(t.is_alive() for t in threads):
        raise AssertionError(f"{what}: client errors {got['errors'][:3]}")
    t1 = time.perf_counter()
    for ids, rows in got["lookups"]:
        oracle.check(what, ids, rows, rtol)
    for rows in got["scans"]:
        if len(rows) != 100:
            raise AssertionError(f"{what}: scan(limit=100) gave "
                                 f"{len(rows)} rows")
        oracle.check_scan(what, rows)
    n_l, n_s = len(got["lookups"]), len(got["scans"])
    return {"clients": clients, "seconds": elapsed,
            "lookup_counters": lookup_counters(counters0),
            "qps": (n_l + n_s) / elapsed, "lookup_qps": n_l / elapsed,
            "scan_qps": n_s / elapsed, "busy_429": got["busy"],
            "lookups": n_l, "scans": n_s,
            "p50_ms": pct(got["lat"], 50), "p95_ms": pct(got["lat"], 95),
            "p99_ms": pct(got["lat"], 99),
            "checked_s": time.perf_counter() - t1}


def lookup_counters(since=None) -> dict:
    """The lookup metric group's counters (block cache, SST builds and
    reuses, native probes), as deltas from `since` when given."""
    from paimon_tpu_torch.metrics import global_registry
    now = {k: v for k, v in global_registry().snapshot().get(
        "lookup", {}).items() if isinstance(v, int)}
    return now if since is None else \
        {k: v - since.get(k, 0) for k, v in now.items()}


def served_rows(load: dict) -> int:
    """Keys looked up plus rows scanned in a client_load window."""
    return load["lookups"] * SERVE_BATCH + load["scans"] * 100


def thread_launches(capture, name: str) -> dict:
    """{thread-name prefix: (plain, ovc) launches} of table `name`."""
    out = {}
    for (table, variant, thread), n in capture.threads.items():
        if table == name:
            c = out.setdefault(thread, [0, 0])
            c[variant == "ovc"] += n
    return out


def serve_agg(work: str, rec: Recorder, batches, rows: int, device,
              clients: int, seconds: float) -> dict:
    """serve_agg_312K: the same rows under aggregation (v sum), whose
    every /lookup takes the merged fallback; see `serving`."""
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.service import KvQueryClient, KvQueryServer
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType

    name = "serve_agg_312K"
    path = os.path.join(work, name)
    dev = torch.device(device)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", DoubleType())
              .column("name", VarCharType.string_type()).primary_key("id")
              .options({"bucket": str(SERVE_BUCKETS), "write-only": "true",
                        "parquet.enable.dictionary": "false",
                        "merge-engine": "aggregation",
                        "fields.v.aggregate-function": "sum"}).build())
    table = FileStoreTable.create(path, schema, device=device)

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write", rows, dev, write)
    oracle = ServeOracle(rows, batches, summed=True)
    out = {"rows": rows, "live": int(oracle.live.sum())}
    served = FileStoreTable.load(path, device=device, dynamic_options={
        "service.lookup.refresh-interval": "1000"})
    server = KvQueryServer(served).start()
    try:
        q = server.query()
        builds, read_split = [], q._read.read_split

        def timed_read(split):
            t0 = time.perf_counter()
            res = read_split(split)
            builds.append((split.bucket, t0, time.perf_counter(),
                           res.num_rows))
            return res
        q._read.read_split = timed_read
        # one key of each bucket from its own client thread at once
        from paimon_tpu_torch.core.bucket import FixedBucketAssigner
        import pyarrow as pa
        probe = np.arange(4096)
        bucket = FixedBucketAssigner(["id"], [BigIntType(False)],
                                     SERVE_BUCKETS).assign(
            pa.table({"id": pa.array(probe, pa.int64())}))
        firsts = [int(probe[np.flatnonzero(bucket == b)[0]])
                  for b in range(SERVE_BUCKETS)]
        answers, errors = {}, []

        def cold(i):
            try:
                with KvQueryClient(address=server.address) as c:
                    answers[i] = c.lookup_row({"id": i})
            except Exception as e:      # noqa: BLE001 -- raised below
                errors.append(repr(e))

        def cold_builds():
            threads = [threading.Thread(target=cold, args=(i,), daemon=True)
                       for i in firsts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        rec.run(name, "cold merged builds", rows, dev, cold_builds)
        if errors or len(answers) != SERVE_BUCKETS:
            raise AssertionError(f"{name}: cold builds {errors[:3]}")
        for i, row in answers.items():
            oracle.check(f"{name} cold", [i], [row], rtol=1e-12)
        if sorted(b for b, *_ in builds) != list(range(SERVE_BUCKETS)):
            raise AssertionError(f"{name}: merged builds {builds}")
        # how many bucket builds ran at once
        edges = sorted([(t0, 1) for _, t0, _, _ in builds]
                       + [(t1, -1) for _, _, t1, _ in builds])
        overlap = max(np.cumsum([d for _, d in edges]))
        out["merged_build_s"] = {str(b): t1 - t0 for b, t0, t1, _ in builds}
        out["merged_rows"] = {str(b): n for b, _, _, n in builds}
        out["builds_at_once"] = int(overlap)
        out["cold_peak_gib"] = rec.phases[-1]["peak_gib"]
        out["cold_s"] = rec.phases[-1]["s"]
        if overlap < 2:
            raise AssertionError(f"{name}: the bucket builds did not "
                                 f"overlap ({builds})")
        out["cold_thread_launches"] = thread_launches(rec.capture, name)
        rng = np.random.default_rng(4)
        with KvQueryClient(address=server.address) as c:
            ids = rng.integers(0, rows, 2048)
            oracle.check(f"{name} warm-up", ids,
                         c.lookup([{"id": int(i)} for i in ids]),
                         rtol=1e-12)
        out["point_gets"] = gets = {}
        rec.run(name, "point gets", lambda: served_rows(gets), dev,
                lambda: gets.update(client_load(
                    server, oracle, clients, seconds, 0.0,
                    f"{name} point gets", rtol=1e-12)))
    finally:
        server.stop()
    shutil.rmtree(path, ignore_errors=True)
    return out


def serving(work: str, rec: Recorder, rows: int = SERVE_ROWS,
            device="cuda", clients: int = 64,
            agg_seconds: float = 0.25) -> dict:
    """The merged lookups of the serving plane on the card.

    serve_agg_312K: benchmarks/serve_bench.py's table (id BIGINT NOT
    NULL key, v DOUBLE, name STRING; bucket=4, write-only, no parquet
    dictionary; 4 commits of rows / 4 ids uniform in [0, rows) from seed
    11) under aggregation (v sum), served by one KvQueryServer: 4 cold
    buckets built at once from 4 client threads, each a full
    merge-on-read on the card, a 2048-key warm-up, then `clients`
    client threads of point gets for `agg_seconds`.  Every answer is
    held against a numpy oracle; the merged builds must launch the
    offset-value-code variant from the handler threads.  The
    deduplicate table of this phase until the serving fleet came
    (serve_dedup_312K) is served by the fleet now (`serving_fleet`)."""
    t0 = time.perf_counter()
    batches = serving_batches(rows)
    out = {"card": card_line() if device == "cuda" else None,
           "batch": SERVE_BATCH, "make_rows_s": time.perf_counter() - t0}
    out["agg"] = serve_agg(work, rec, batches, rows, device, clients,
                           agg_seconds)
    ovc = sum(o for _, o in out["agg"]["cold_thread_launches"].values())
    from_workers = sum(o for t, (_, o) in
                       out["agg"]["cold_thread_launches"].items()
                       if t.startswith("paimon-serve"))
    if ovc == 0 or from_workers == 0:
        raise AssertionError(f"serve_agg_312K: the offset-value-code "
                             f"variant did not launch from the handler "
                             f"threads ({out['agg']['cold_thread_launches']})")
    out["launches"] = {f"{p['table']} {p['phase']}":
                       [p["launches_plain"], p["launches_ovc"]]
                       for p in rec.phases
                       if p["table"].startswith("serve_agg")}
    out["peak_gib"] = {f"{p['table']} {p['phase']}": p["peak_gib"]
                       for p in rec.phases
                       if p["table"].startswith("serve_agg")}
    out["s"] = time.perf_counter() - t0
    return out


# -- serving_fleet: the query service for lookup joins over an object store

FLEET_ROWS = 4_000_000           # serve_fleet_4M: 4 commits of 1M ids
FLEET_REPLICAS = 4
FLEET_REMOTE_ID = 4              # the replica in a process of its own
FLEET_TENANTS = 256
FLEET_CLIENTS = 64
FLEET_SECONDS = 4.0              # each load window: router, smart clients
# a percentile of a window is reported where at least this many samples
# lie beyond it (p99 wants 1,000 requests), else null
FLEET_TAIL_SAMPLES = 10
# GETs that build the store's latency model before the scans of step 9
FLEET_HEDGE_WARMUP = 400
FLEET_HEALTH_MS = 500
FLEET_SCHEME = "fleet"
FLEET_WARMUP = 2048              # warm-up keys, spread over the replicas
FLEET_READERS = 8                # clients reading through the compaction
FLEET_DISK_BYTES = 1 << 30
# the store's round trip: chaos_bench's tail shape, 1% of GETs 20x slow
FLEET_STORE = {"base_ms": 8.0, "jitter_ms": 1.0, "tail_rate": 0.01,
               "tail_multiplier": 20.0, "seed": 42}
FLEET_DEADLINE_MS = 200
FLEET_STUCK_MS = 5000


def fleet_options(ssd: str) -> dict:
    """The deployment's options over the base table's: Paimon's query
    service with a parallelism (service.replicas) on the host-SSD cache
    and tail-tolerance options of tier_bench and chaos_bench."""
    return {"service.replicas": str(FLEET_REPLICAS),
            "service.warmboot.enabled": "true",
            "cache.disk.dir": ssd, "cache.disk.max-bytes": "1 gb",
            "read.hedge.enabled": "true", "read.hedge.min-delay": "2",
            "store.breaker.enabled": "true",
            "service.replicas.health-interval": f"{FLEET_HEALTH_MS} ms",
            "service.lookup.refresh-interval": "1000"}


class StoreCounter:
    """An object-store backend that counts its inner store's calls by op
    with their wall milliseconds (the injected latency included), the
    GETs of data files apart, and keeps each GET's milliseconds; it
    sits under the resilient layer, so hedges and retries count as the
    store sees them."""

    OPS = ("put", "get", "head", "list", "delete", "data_get")

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self.calls = dict.fromkeys(self.OPS, 0)
        self.ms = dict.fromkeys(self.OPS, 0.0)
        self.get_ms: list = []

    def _timed(self, op, fn, key=""):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                self.calls[op] += 1
                self.ms[op] += ms
                if op == "get":
                    self.get_ms.append(ms)
                    if key.rsplit("/", 1)[-1].startswith("data-"):
                        self.calls["data_get"] += 1
                        self.ms["data_get"] += ms

    def put(self, key, data, if_none_match=False):
        return self._timed("put", lambda: self.inner.put(
            key, data, if_none_match=if_none_match))

    def get(self, key, offset=0, length=None):
        return self._timed("get", lambda: self.inner.get(key, offset,
                                                         length), key)

    def head(self, key):
        return self._timed("head", lambda: self.inner.head(key))

    def list(self, prefix):
        return self._timed("list", lambda: self.inner.list(prefix))

    def delete(self, key):
        return self._timed("delete", lambda: self.inner.delete(key))

    def mark(self) -> tuple:
        with self._lock:
            return dict(self.calls), dict(self.ms), len(self.get_ms)

    def since(self, mark: tuple) -> dict:
        calls, ms, gets = mark
        with self._lock:
            return {"calls": {k: self.calls[k] - calls[k] for k in self.OPS},
                    "ms": {k: self.ms[k] - ms[k] for k in self.OPS},
                    "get_p50_ms": pct(self.get_ms[gets:], 50),
                    "get_p99_ms": pct(self.get_ms[gets:], 99)}


def fleet_store(root: str, **extra):
    """(the counted store, its FileIO): LocalObjectStoreBackend at `root`
    under LatencyInjectingObjectStoreBackend in FLEET_STORE's shape."""
    from paimon_tpu_torch.fs.object_store import (
        LatencyInjectingObjectStoreBackend, LocalObjectStoreBackend,
        ObjectStoreFileIO,
    )
    store = StoreCounter(LatencyInjectingObjectStoreBackend(
        LocalObjectStoreBackend(root), **{**FLEET_STORE, **extra}))
    return store, ObjectStoreFileIO(store, scheme=f"{FLEET_SCHEME}://")


def fleet_child_start(root: str, device: str, out: str):
    """The start of a process of serve_fleet's (FleetChild): it reaches
    the card at once, registers the fleet's scheme over its own FileIO
    of the store and waits for `out`.go, written by its parent; (the
    counted store, the seconds to the card, the contents of `out`.go,
    the seconds it waited for them), or None when the parent exits
    first."""
    import torch

    from paimon_tpu_torch.fs import register_file_io

    t0 = time.perf_counter()
    parent = os.getppid()
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    store, fio = fleet_store(root)
    register_file_io(FLEET_SCHEME, lambda: fio)
    t1 = time.perf_counter()
    while not os.path.exists(out + ".go"):
        if os.getppid() != parent:
            return None
        time.sleep(0.02)
    with open(out + ".go") as f:
        return store, card_s, f.read().strip(), time.perf_counter() - t1


def fleet_child_done(out: str, result: dict) -> None:
    with open(out + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(out + ".tmp", out + ".json")


def fleet_remote(root: str, path: str, ssd: str, out: str,
                 device: str) -> None:
    """serve_fleet's remote replica, a process of its own (FleetChild):
    given the router's address in `out`.go, it serves the table over
    the same store and SSD directory as replica FLEET_REMOTE_ID,
    registers with the router and writes `out`.json; it serves until it
    is killed or its parent exits."""
    from paimon_tpu_torch.service import KvQueryServer
    from paimon_tpu_torch.table import FileStoreTable

    started = fleet_child_start(root, device, out)
    if started is None:
        return
    _, card_s, router, waited_s = started
    parent = os.getppid()
    t1 = time.perf_counter()
    table = FileStoreTable.load(path, dynamic_options=fleet_options(ssd),
                                device=device)
    server = KvQueryServer(table, replica_id=FLEET_REMOTE_ID)
    server.server.start()
    registered = server.register_with_router(router)
    fleet_child_done(out, {"address": server.address,
                           "registered": registered, "card_s": card_s,
                           "waited_s": waited_s,
                           "join_s": time.perf_counter() - t1})
    while os.getppid() == parent:
        time.sleep(0.2)


def fleet_restarted(root: str, path: str, ssd: str, out: str,
                    device: str) -> None:
    """serve_fleet's step 4, a process of its own (FleetChild) as a
    restarted host runs it: empty memory tiers and counters, the SSD
    directory and the warm-boot state on disk.  Given the id range in
    `out`.go, it starts a ReplicaSet of FLEET_REPLICAS with warm boot,
    sends each replica's first tenant a lookup of SERVE_BATCH keys,
    then one scan(limit=100), and writes `out`.json: the answers (the
    parent holds them against its oracle), each replica's warm restore,
    the process's reader builds and SSD-tier hits, the store's calls
    and the tier's bytes.  Then it stops the set and exits."""
    from paimon_tpu_torch.fs.caching import shared_cache_state
    from paimon_tpu_torch.metrics import (
        CACHE_DISK_HITS, LOOKUP_READER_BUILDS, global_registry,
    )
    from paimon_tpu_torch.service import KvQueryClient, ReplicaSet
    from paimon_tpu_torch.table import FileStoreTable

    started = fleet_child_start(root, device, out)
    if started is None:
        return
    store, card_s, rows, waited_s = started
    reg = global_registry()
    builds0 = reg.lookup_metrics().counter(LOOKUP_READER_BUILDS).count
    hits0 = reg.cache_disk_metrics().counter(CACHE_DISK_HITS).count
    mark = store.mark()
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    fleet = ReplicaSet(FileStoreTable.load(
        path, dynamic_options=fleet_options(ssd), device=device)).start()
    try:
        start_s = time.perf_counter() - t0
        first = {rid: ts[0] for rid, ts in
                 sorted(tenants_by_replica(fleet.router.ring).items())}
        lookups = []
        t1 = time.perf_counter()
        for tenant in first.values():
            ids = rng.integers(0, int(rows), SERVE_BATCH)
            with KvQueryClient(address=fleet.address, tenant=tenant) as c:
                got = c.lookup([{"id": int(i)} for i in ids])
                lookups.append({"tenant": tenant, "ids": ids.tolist(),
                                "rows": got, "replica": int(c.last_replica)})
        first_ms = (time.perf_counter() - t1) * 1000.0
        built = reg.lookup_metrics().counter(LOOKUP_READER_BUILDS).count \
            - builds0
        # one scan reads the data files: from the SSD tier, then from
        # the memory tier for any replica after it
        with KvQueryClient(address=fleet.address,
                           tenant=next(iter(first.values()))) as c:
            scans = [c.scan(limit=100)]
        tier = shared_cache_state().disk
        result = {
            "card_s": card_s, "waited_s": waited_s, "start_s": start_s,
            "work_s": time.perf_counter() - t0, "first_lookups_ms": first_ms,
            "reader_builds": built,
            "restored": [s.last_warm_restore for s in fleet.servers],
            "disk_hits": reg.cache_disk_metrics().counter(
                CACHE_DISK_HITS).count - hits0,
            "store": store.since(mark), "tier_bytes": tier.total_bytes,
            "tier_entries": len(tier), "lookups": lookups, "scans": scans}
    finally:
        fleet.stop()
    fleet_child_done(out, result)


class FleetChild:
    """A function of this script (`fleet_remote`, `fleet_restarted`) in
    a process of its own, started steps before serve_fleet needs it so
    that its start on the card overlaps the phase's work."""

    def __init__(self, fn: str, root: str, path: str, ssd: str, out: str,
                 dev):
        here = os.path.dirname(os.path.abspath(__file__))
        self.out = out
        self.t0 = time.perf_counter()
        self.err = open(out + ".err", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import sys, chip_smoke; "
             f"chip_smoke.{fn}(*sys.argv[1:])", root, path, ssd, out,
             dev.type], cwd=here, env=dict(os.environ, PYTHONPATH=here),
            stdout=subprocess.DEVNULL, stderr=self.err)

    def join(self, go: str, timeout: float = 300.0) -> dict:
        """Hand it `go`; wait for what it writes."""
        with open(self.out + ".go.tmp", "w") as f:
            f.write(go)
        os.replace(self.out + ".go.tmp", self.out + ".go")
        deadline = time.perf_counter() + timeout
        while not os.path.exists(self.out + ".json"):
            if self.proc.poll() is not None or \
                    time.perf_counter() > deadline:
                self.stop()
                with open(self.out + ".err") as f:
                    err = f.read()[-800:]
                raise AssertionError(f"{os.path.basename(self.out)}: exit "
                                     f"{self.proc.returncode}: {err}")
            time.sleep(0.02)
        with open(self.out + ".json") as f:
            return json.load(f)

    def kill(self) -> None:
        self.proc.kill()            # SIGKILL: no shutdown, no persist
        self.proc.wait()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


def http_json(address: str, path: str, body=None, timeout: float = 30.0):
    """GET (or POST `body`) `path` of a server; (status, parsed JSON or
    text)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        address + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read()
    try:
        return status, json.loads(data)
    except ValueError:
        return status, data.decode()


def tenants_by_replica(ring, n: int = FLEET_TENANTS) -> dict:
    """{replica id: [tenant, ...]} of tenants t0..t<n-1> on `ring`."""
    out: dict = {}
    for i in range(n):
        out.setdefault(ring.pick(f"t{i}")["id"], []).append(f"t{i}")
    return out


def tail_pct(vals, p: float):
    """pct(vals, p) where FLEET_TAIL_SAMPLES samples or more lie beyond
    it, else None: too few samples to support that percentile."""
    return pct(vals, p) \
        if len(vals) * (100 - p) / 100 >= FLEET_TAIL_SAMPLES else None


def fleet_load(address: str, oracle: ServeOracle, clients: int,
               seconds: float, follow: bool, what: str) -> dict:
    """`clients` client threads over FLEET_TENANTS tenants (each thread
    round-robin over its tenants' keep-alive clients): 90% gets of
    SERVE_BATCH keys, 10% scan(limit=100), through the router
    (`follow`=False) or to each tenant's replica (`follow`=True).

    Each client makes one lookup before the window opens, so that its
    connections and its /topology probe are paid outside it.  The
    window is `seconds` long and opens when every thread is ready; the
    rate and the latencies count the requests that finish inside it,
    and the rate divides by `seconds`.  Every answer, inside the window
    or not, is held against the oracle afterwards, and its (tenant,
    replica) kept."""
    from paimon_tpu_torch.service import KvQueryClient, ServiceBusyError
    stop = threading.Event()
    ready = threading.Barrier(clients + 1)
    lock = threading.Lock()
    # done: (finish time, ms, "lookup" or "scan") of every request
    got = {"lookups": [], "scans": [], "done": [], "seen": [], "busy": 0,
           "errors": [], "warm": 0}

    def worker(i):
        r = np.random.default_rng(3000 + i)
        mine = {"lookups": [], "scans": [], "done": [], "seen": [],
                "busy": 0}
        cs = [KvQueryClient(address=address, tenant=f"t{k}",
                            follow_topology=follow)
              for k in range(i, FLEET_TENANTS, clients)]
        try:
            try:
                for c in cs:
                    ids = r.integers(0, oracle.rows, SERVE_BATCH)
                    mine["lookups"].append(
                        (ids, c.lookup([{"id": int(x)} for x in ids])))
                    mine["seen"].append((c.tenant, int(c.last_replica)))
            finally:
                ready.wait(timeout=300)
            j = 0
            while not stop.is_set():
                c = cs[j % len(cs)]
                j += 1
                try:
                    t1 = time.perf_counter()
                    if r.random() >= 0.1:
                        ids = r.integers(0, oracle.rows, SERVE_BATCH)
                        rows = c.lookup([{"id": int(x)} for x in ids])
                        mine["lookups"].append((ids, rows))
                        kind = "lookup"
                    else:
                        mine["scans"].append(c.scan(limit=100))
                        kind = "scan"
                    t2 = time.perf_counter()
                    mine["done"].append((t2, (t2 - t1) * 1000.0, kind))
                    mine["seen"].append((c.tenant, int(c.last_replica)))
                except ServiceBusyError:
                    mine["busy"] += 1
                    time.sleep(0.002)
        except Exception as e:      # noqa: BLE001 -- reported, then raised
            with lock:
                got["errors"].append(repr(e))
        finally:
            for c in cs:
                c.close()
        with lock:
            for k in ("lookups", "scans", "done", "seen"):
                got[k].extend(mine[k])
            got["busy"] += mine["busy"]
            got["warm"] += len(cs)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    ready.wait(timeout=300)
    opened = time.perf_counter()
    time.sleep(seconds)
    closed = time.perf_counter()
    stop.set()
    for t in threads:
        t.join(timeout=120)
    drained = time.perf_counter()
    if got["errors"] or any(t.is_alive() for t in threads):
        raise AssertionError(f"{what}: client errors {got['errors'][:3]}")
    t1 = time.perf_counter()
    for ids, rows in got["lookups"]:
        oracle.check(what, ids, rows)
    for rows in got["scans"]:
        if len(rows) != 100:
            raise AssertionError(f"{what}: scan(limit=100) gave "
                                 f"{len(rows)} rows")
        oracle.check_scan(what, rows)
    inside = [(ms, kind) for end, ms, kind in got["done"]
              if opened <= end <= closed]
    lat = [ms for ms, _ in inside]
    lookup_lat = [ms for ms, kind in inside if kind == "lookup"]
    by_replica: dict = {}
    for _, rid in got["seen"]:
        by_replica[str(rid)] = by_replica.get(str(rid), 0) + 1
    n_scans = sum(kind == "scan" for _, kind in inside)
    return {"clients": clients, "tenants": FLEET_TENANTS,
            "follow_topology": follow, "window_s": seconds,
            "ready_s": opened - t0, "drain_s": drained - closed,
            "warm_requests": got["warm"], "requests": len(inside),
            "requests_per_s": len(inside) / seconds,
            "lookups": len(inside) - n_scans, "scans": n_scans,
            "after_window": len(got["done"]) - len(inside),
            "busy_429": got["busy"],
            "p50_ms": tail_pct(lat, 50), "p95_ms": tail_pct(lat, 95),
            "p99_ms": tail_pct(lat, 99),
            "lookup_p50_ms": tail_pct(lookup_lat, 50),
            "lookup_p99_ms": tail_pct(lookup_lat, 99),
            "by_replica": by_replica, "seen": got["seen"],
            "checked_s": time.perf_counter() - t1}


def data_paths(table) -> set:
    """The paths of the data files of `table`'s latest snapshot."""
    from paimon_tpu_torch.utils.path_factory import FileStorePathFactory
    paths = FileStorePathFactory(table.path, table.schema.partition_keys)
    return {f.external_path or
            paths.data_file_path(s.partition, s.bucket, f.file_name)
            for s in table.new_read_builder().new_scan().plan().splits
            for f in s.data_files}


def reload_plans(fleet) -> None:
    """Every replica of `fleet` reloads its plan now: refresh() lifts
    its snapshot check's interval, and a lookup of no keys makes the
    check, building no reader."""
    for s in fleet.servers:
        q = s.query()
        q.refresh()
        q.lookup([])


def launches_since(capture, name: str, before: dict) -> dict:
    """{thread-name prefix: [plain, ovc]} launches of table `name` since
    `before`, a thread_launches reading."""
    return {t: [a - b for a, b in zip(n, before.get(t, (0, 0)))]
            for t, n in thread_launches(capture, name).items()
            if list(n) != list(before.get(t, (0, 0)))}


def warm_latency_model(fio, small: list, large: list, calls: int) -> None:
    """`calls` GETs through `fio`, 16 threads at a time, round-robin:
    whole reads of the `small` objects and the first 4 KiB of the
    `large` ones, so that the latency model of the resilient layer
    under `fio` has its samples for both kinds of GET, as a serving
    process's has."""
    from concurrent.futures import ThreadPoolExecutor

    def get(k):
        if k % 2:
            fio.read_range(large[k // 2 % len(large)], 0, 4096)
        else:
            fio.read_bytes(small[k // 2 % len(small)])
    with ThreadPoolExecutor(16) as pool:
        list(pool.map(get, range(calls)))


def check_fleet_table(what: str, oracle: ServeOracle, t) -> None:
    """A whole-table read against the oracle, vectorized: every live id
    once, with its last writer's v and name."""
    import pyarrow as pa
    import pyarrow.compute as pc
    ids = t.column("id").to_numpy()
    if len(ids) != int(oracle.live.sum()) or \
            len(np.unique(ids)) != len(ids) or not oracle.live[ids].all():
        raise AssertionError(f"{what}: {len(ids)} rows, "
                             f"{int(oracle.live.sum())} live ids")
    if not np.array_equal(t.column("v").to_numpy(), oracle.v[ids]):
        raise AssertionError(f"{what}: a v differs from the oracle")
    tags = oracle.tag[ids].astype(np.int64)
    codes, index = np.unique(tags, return_inverse=True)
    prefix = pa.array([f"c{c}" if c < 100 else f"w{c - 100}"
                       for c in codes]).take(pa.array(index))
    want = pc.binary_join_element_wise(
        prefix, pc.cast(pa.array(ids % 997), pa.string()), "-")
    if not t.column("name").combine_chunks().equals(want):
        raise AssertionError(f"{what}: a name differs from the oracle")


class TimedReads:
    """A table's FileIO with each read's wall milliseconds kept: the
    latency the scan sees, after hedging."""

    def __init__(self, inner):
        self.inner = inner
        self.ms: list = []

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.ms.append((time.perf_counter() - t0) * 1000.0)
        return out

    def read_bytes(self, path):
        return self._timed(self.inner.read_bytes, path)

    def read_range(self, path, offset, length):
        return self._timed(self.inner.read_range, path, offset, length)

    def read_ranges(self, path, ranges):
        return self._timed(self.inner.read_ranges, path, ranges)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def serving_fleet(work: str, rec: Recorder, rows: int = FLEET_ROWS,
                  device="cuda", clients: int = FLEET_CLIENTS,
                  seconds: float = FLEET_SECONDS) -> dict:
    """serve_fleet_4M: Paimon's query service for lookup joins (the
    Paimon docs' "Query Service" page, sys.query_service with a
    parallelism) over a table on an object store, with the host-SSD
    cache and the tail-tolerance options of the reference's
    benchmarks/tier_bench.py and chaos_bench.py, served by replicas
    behind the router as in benchmarks/serve_bench.py's replicated rig.

    The table is serve_bench.py's (id BIGINT NOT NULL key, v DOUBLE,
    name STRING; bucket=4, write-only, no parquet dictionary; 4 commits
    of rows / 4 ids uniform in [0, rows) from seed 11) on
    ObjectStoreFileIO over LocalObjectStoreBackend under
    LatencyInjectingObjectStoreBackend (8 ms a call, 1 ms jitter, 1% of
    GETs 20x slow), registered under a scheme of its own; the served
    tables take `fleet_options`.  Steps, every answer held against a
    numpy oracle:
     1. a remote replica (id 4) and the restarted host of step 5b start
        in processes of their own, so that both are idle before the load
        windows of step 5;
     2. the write, with the store's calls and K1 at each flush;
     3. a ReplicaSet of 4: the cold first /lookup of 8 keys and a
        2,048-key warm-up of one tenant through the router, so that its
        replica builds every file's SST; POST /warmboot to each (the
        warm one persists); /scan(limit=100) on as many replicas as
        cache.disk.promote-after-hits; stop;
     4. this process's warm-booted ReplicaSet and the engine's probe,
        native and numpy;
     5. the first scan on each replica of this process launches K1 from
        the replicas' scan threads; the remote registers; `clients`
        threads over 256
        tenants for a `seconds` window through the router, then as smart
        clients (`fleet_load`): all 5 replicas answer, each tenant on
        its HashRing replica, /healthz rolls up 5 and /metrics carries
        replica="4";
    5b. the restarted host (`fleet_restarted`, before any commit): a
        ReplicaSet restoring the warm state, each replica's first lookup
        with zero reader builds, a /scan(limit=100) served by the SSD
        tier (disk hits > 0, fewer data-file GETs from the store than
        step 3), the tier inside cache.disk.max-bytes;
     6. SIGKILL of the remote: suspended within 4 health intervals plus
        1 s, its tenants rehashed and answered exactly;
     7. the fleet's serving writer upserts 50,000 live ids in batches of
        10,000, each read back on every replica before its commit, each
        commit inside a span stamping trace.context;
     8. a /scan of 50,000 rows through the router (merging the writer's
        runs), a full compaction while 8 clients read, the dropped files
        gone from both tiers (the SSD tier's evictions counted) and
        from every replica's SSTs, the /scan again (one sorted run a
        bucket: a raw read);
     9. the whole table read twice through copies without the disk
        tier, unhedged and hedged, each over a store whose latency
        model FLEET_HEDGE_WARMUP GETs have built first: rows identical
        and exact, the GETs' p50 and p99, hedges issued and won on the
        hedged store, and within the cap of hedgeable calls;
    10. a read with request.timeout=200 ms over a store whose every call
        stalls 5 s raises the deadline error within 1 s; the next read
        without the stall is exact;
    11. GET /slo through the router: aggregate_slo over the replicas.
    """
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.fs import register_file_io
    from paimon_tpu_torch.fs.caching import (
        reset_disk_tiers, shared_cache_state,
    )
    from paimon_tpu_torch.lookup.sst import force_python_probe
    from paimon_tpu_torch.metrics import (
        CACHE_DISK_EVICTIONS, LOOKUP_NATIVE_FALLBACKS, LOOKUP_NATIVE_PROBES,
        LOOKUP_READER_BUILDS, RESILIENCE_HEDGES_ABANDONED, RESILIENCE_HEDGES_ISSUED,
        RESILIENCE_HEDGES_WON, SERVICE_SCAN_CACHE_HITS,
        SERVICE_SCAN_CACHE_MISSES, global_registry,
    )
    from paimon_tpu_torch.obs import trace
    from paimon_tpu_torch.options import CoreOptions
    from paimon_tpu_torch.service import KvQueryClient, ReplicaSet
    from paimon_tpu_torch.service.delta import reset_delta_tiers
    from paimon_tpu_torch.service.router import HashRing
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType
    from paimon_tpu_torch.utils.deadline import DeadlineExceededError

    t_phase = time.perf_counter()
    name = f"serve_fleet_{rows // 1_000_000}M"
    dev = torch.device(device)
    root = os.path.join(work, "fleet-bucket")
    ssd = os.path.join(work, "fleet-ssd")
    path = f"{FLEET_SCHEME}://{name}"
    reg = global_registry()

    def counter(group, metric):
        return getattr(reg, f"{group}_metrics")().counter(metric).count

    out = {"card": card_line() if dev.type == "cuda" else None,
           "rows": rows, "replicas": FLEET_REPLICAS, "steps_s": {},
           "store": {}}
    steps = out["steps_s"]

    def step(what, t0):
        steps[what] = time.perf_counter() - t0
        log(f"  {name} {what}: {steps[what]:.2f} s")

    t0 = time.perf_counter()
    remote = FleetChild("fleet_remote", root, path, ssd,
                        os.path.join(work, "fleet-remote"), dev)
    restart = FleetChild("fleet_restarted", root, path, ssd,
                         os.path.join(work, "fleet-restarted"), dev)
    sets = []
    probes0 = counter("lookup", LOOKUP_NATIVE_PROBES)
    fallbacks0 = counter("lookup", LOOKUP_NATIVE_FALLBACKS)
    try:
        store, fio = fleet_store(root)
        register_file_io(FLEET_SCHEME, lambda: fio)
        batches = serving_batches(rows)
        step("1 remote and restarted host started, batches made", t0)

        # -- 2. the write ------------------------------------------------
        t0 = time.perf_counter()
        schema = (Schema.builder().column("id", BigIntType(False))
                  .column("v", DoubleType())
                  .column("name", VarCharType.string_type())
                  .primary_key("id")
                  .options({"bucket": str(SERVE_BUCKETS),
                            "write-only": "true",
                            "parquet.enable.dictionary": "false"}).build())
        table = FileStoreTable.create(path, schema, device=device)
        mark = store.mark()
        flushes = []

        def write():
            for b in batches:
                before = rec.counts()[0]
                wb = table.new_batch_write_builder()
                with wb.new_write() as w:
                    w.write_arrow(b)
                    wb.new_commit().commit(w.prepare_commit())
                flushes.append(rec.counts()[0] - before)
        rec.run(name, "write", rows, dev, write)
        out["write"] = {"rows_per_s": rec.phases[-1]["rows_per_s"],
                        "k1_by_commit": flushes}
        out["store"]["write"] = store.since(mark)
        if min(flushes) == 0:
            raise AssertionError(f"{name}: a commit's flush launched no K1 "
                                 f"({flushes})")
        oracle = ServeOracle(rows, batches)
        del batches
        out["live"] = int(oracle.live.sum())
        step("2 write", t0)

        def served():
            return FileStoreTable.load(path, device=device,
                                       dynamic_options=fleet_options(ssd))

        def lookup_on(address, tenant, ids, follow=True):
            with KvQueryClient(address=address, tenant=tenant,
                               follow_topology=follow) as c:
                rows_ = c.lookup([{"id": int(i)} for i in ids])
                return rows_, int(c.last_replica)

        rng = np.random.default_rng(3)

        # -- 3. the first ReplicaSet: cold, warm-up, persist -------------
        t0 = time.perf_counter()
        mark = store.mark()
        fleet1 = ReplicaSet(served()).start()
        sets.append(fleet1)
        if len(tenants_by_replica(fleet1.router.ring)) != FLEET_REPLICAS:
            raise AssertionError(f"{name}: a replica owns no tenant")
        # one tenant: its replica builds every file's SST, the state
        # every replica of the next set restores
        ids = rng.integers(0, rows, SERVE_BATCH)
        t1 = time.perf_counter()
        got, warm_id = lookup_on(fleet1.address, "t0", ids)
        out["cold_lookup_ms"] = (time.perf_counter() - t1) * 1000.0
        oracle.check(f"{name} cold lookup", ids, got)

        def warm_up():
            ids_ = rng.integers(0, rows, FLEET_WARMUP)
            got_, by = lookup_on(fleet1.address, "t0", ids_, follow=False)
            oracle.check(f"{name} warm-up", ids_, got_)
            if by != warm_id:
                raise AssertionError(f"{name}: tenant t0 answered by {by}, "
                                     f"then {warm_id}")
        rec.run(name, "warm-up lookup", FLEET_WARMUP, dev, warm_up)
        warm = fleet1.servers[warm_id].query()
        n_files = len(data_paths(served()))
        if len(warm.store.keys()) != n_files:
            raise AssertionError(f"{name}: replica {warm_id} holds "
                                 f"{len(warm.store.keys())} SSTs, "
                                 f"{n_files} files")
        # POST /warmboot to each replica: the warm one persists, the
        # others have served nothing and persist nothing
        persisted = []
        for s in fleet1.servers:
            status, body = http_json(s.address, "/warmboot", {})
            want = n_files if s.replica_id == warm_id else 0
            if status != 200 or body["ssts"] != want or \
                    bool(body["plan"]) != bool(want):
                raise AssertionError(f"{name}: POST /warmboot to replica "
                                     f"{s.replica_id}: {status} {body}")
            persisted.append(body["ssts"])
        # /scan(limit=100) on as many replicas as a file needs memory
        # hits to earn its promotion to the SSD tier
        # (cache.disk.promote-after-hits): each replica's first scan
        # reads once the files that the build put in memory
        promote = served().options.get(CoreOptions.CACHE_DISK_PROMOTE_HITS)
        for r_id, ts in sorted(
                tenants_by_replica(fleet1.router.ring).items())[:promote]:
            with KvQueryClient(address=fleet1.address, tenant=ts[0]) as c:
                oracle.check_scan(f"{name} cold scan", c.scan(limit=100))
        fleet1.stop()
        sets.remove(fleet1)
        out["store"]["cold"] = store.since(mark)
        out["persisted_ssts"] = persisted
        step("3 cold set, warm-up, persist", t0)

        # -- 4. this process's warm-booted set -----------------------------
        t0 = time.perf_counter()
        builds0 = counter("lookup", LOOKUP_READER_BUILDS)
        fleet = ReplicaSet(served()).start()
        sets.append(fleet)
        q = fleet.servers[0].query()
        ids = rng.integers(0, rows, SERVE_BATCH)
        keys = [{"id": int(i)} for i in ids]
        oracle.check(f"{name} engine probe, native", ids, q.lookup(keys))
        out["warm_set"] = {
            "start_s": time.perf_counter() - t0,
            "reader_builds": counter("lookup", LOOKUP_READER_BUILDS)
            - builds0}
        with force_python_probe():
            oracle.check(f"{name} engine probe, numpy", ids, q.lookup(keys))

        def per_batch_us():
            reps, t1 = 0, time.perf_counter()
            while time.perf_counter() - t1 < 0.25:
                q.lookup(keys)
                reps += 1
            return (time.perf_counter() - t1) / reps * 1e6
        out["engine_native_us_per_batch"] = per_batch_us()
        with force_python_probe():
            out["engine_numpy_us_per_batch"] = per_batch_us()
        step("4 warm-booted set", t0)

        # -- 5. first scans; the remote joins; load through the router
        # and direct
        t0 = time.perf_counter()
        # the first scan(limit=100) at this snapshot on each replica of
        # this process, all at once through the router, while the remote
        # still starts: each merges on the card from the replica's scan
        # threads; the windows' scans are then served by the replicas'
        # snapshot-keyed result caches, as a fleet's are between commits
        # (the remote's first scan merges in its own process)
        firsts = [ts[0] for ts in
                  tenants_by_replica(fleet.router.ring).values()]

        def first_scan(tenant):
            with KvQueryClient(address=fleet.address, tenant=tenant,
                               follow_topology=False) as c:
                return c.scan(limit=100)
        before = thread_launches(rec.capture, name)
        with ThreadPoolExecutor(len(firsts)) as pool:
            got = rec.run(name, "first scans", 100 * len(firsts), dev,
                          lambda: list(pool.map(first_scan, firsts)))
        for rows_ in got:
            oracle.check_scan(f"{name} first scan", rows_)
        out["first_scans"] = {
            "s": rec.phases[-1]["s"],
            "k1_by_thread": launches_since(rec.capture, name, before)}
        from_scans = sum(n[0] for t, n in
                         out["first_scans"]["k1_by_thread"].items()
                         if t.startswith("paimon-scan"))
        if dev.type == "cuda" and from_scans == 0:
            raise AssertionError(f"{name} first scans: no K1 from the scan "
                                 f"threads ({out['first_scans']})")
        t1 = time.perf_counter()
        out["remote"] = remote.join(fleet.address)
        out["remote"]["joined_s"] = time.perf_counter() - t1
        out["remote"]["ready_s"] = time.perf_counter() - remote.t0
        status, topo = http_json(fleet.address, "/topology")
        if [r["id"] for r in topo["replicas"]] != \
                list(range(FLEET_REPLICAS + 1)):
            raise AssertionError(f"{name}: topology {topo}")
        ring = HashRing(topo["replicas"], topo["virtual_nodes"])
        svc = reg.service_metrics(fleet.servers[0].table.name)

        def scan_cache():
            return {k: svc.counter(m).count for k, m in (
                ("hits", SERVICE_SCAN_CACHE_HITS),
                ("misses", SERVICE_SCAN_CACHE_MISSES))}
        for key, follow, what in (("router_load", False, "router load"),
                                  ("smart_load", True, "smart load")):
            load: dict = {}
            before, cache0 = thread_launches(rec.capture, name), scan_cache()
            rec.run(name, what, lambda: served_rows(load), dev,
                    lambda: load.update(fleet_load(
                        fleet.address, oracle, clients, seconds, follow,
                        f"{name} {what}")))
            load["k1_by_thread"] = launches_since(rec.capture, name, before)
            load["scan_cache"] = {k: v - cache0[k]
                                  for k, v in scan_cache().items()}
            out[key] = load
            log(f"  {name} {what}: {load['requests']} requests in the "
                f"{seconds:.1f} s window = {load['requests_per_s']:.1f}/s; "
                f"p50 / p95 / p99 {load['p50_ms']} / {load['p95_ms']} / "
                f"{load['p99_ms']} ms; ready {load['ready_s']:.2f} s, "
                f"drain {load['drain_s']:.2f} s; K1 "
                f"{load['k1_by_thread']}; scan cache {load['scan_cache']}")
        routed, smart = out["router_load"], out["smart_load"]
        answered = set(routed["by_replica"]) | set(smart["by_replica"])
        wrong = [(t, r) for t, r in routed.pop("seen") + smart.pop("seen")
                 if ring.pick(t)["id"] != r]
        if answered != {str(i) for i in range(FLEET_REPLICAS + 1)} or wrong:
            raise AssertionError(f"{name}: answered by {sorted(answered)}; "
                                 f"off their ring replica {wrong[:5]}")
        status, health = http_json(fleet.address, "/healthz")
        if status != 200 or health["replica_count"] != FLEET_REPLICAS + 1 \
                or any("error" in h for h in health["replicas"].values()):
            raise AssertionError(f"{name}: /healthz {health}")
        status, metrics = http_json(fleet.address, "/metrics")
        if f'replica="{FLEET_REMOTE_ID}"' not in metrics:
            raise AssertionError(f"{name}: /metrics carries no "
                                 f"replica=\"{FLEET_REMOTE_ID}\" series")
        out["healthz"] = {"status": health["status"],
                          "replica_count": health["replica_count"]}
        step("5 remote joined, loads", t0)

        # -- 5b. the restarted host ---------------------------------------
        # after the loads, which commit nothing: the persisted state is
        # still the table's, and the host's start has long overlapped
        t0 = time.perf_counter()
        back = restart.join(str(rows))
        restart.stop()
        for a in back["lookups"]:
            oracle.check(f"{name} warm-booted first lookup on replica "
                         f"{a['replica']}", np.array(a["ids"]), a["rows"])
        for rows_ in back["scans"]:
            oracle.check_scan(f"{name} warm scan", rows_)
        out["warm_first_lookups_ms"] = back["first_lookups_ms"]
        out["restarted"] = {k: back[k] for k in (
            "card_s", "waited_s", "start_s", "work_s", "reader_builds",
            "restored", "disk_hits")}
        out["restarted"]["joined_s"] = time.perf_counter() - t0
        out["store"]["warm"] = back["store"]
        on_disk = sum(os.path.getsize(os.path.join(ssd, f))
                      for f in os.listdir(ssd) if f.endswith(".pce"))
        out["disk_tier"] = {"hits": back["disk_hits"],
                            "bytes": back["tier_bytes"],
                            "bytes_on_disk": on_disk,
                            "entries": back["tier_entries"]}
        if back["reader_builds"] or any(
                r["ssts"] != n_files or not r["plan"]
                for r in back["restored"]):
            raise AssertionError(f"{name}: warm boot built "
                                 f"{back['reader_builds']} readers; "
                                 f"restored {back['restored']}")
        # the data files the scan read came from the SSD tier, not the
        # store (snapshot-N and the hints are never cached)
        if back["disk_hits"] <= 0 or \
                back["store"]["calls"]["data_get"] >= \
                out["store"]["cold"]["calls"]["data_get"] or \
                max(back["tier_bytes"], on_disk) > FLEET_DISK_BYTES:
            raise AssertionError(f"{name}: disk hits {back['disk_hits']}, "
                                 f"GETs warm {back['store']['calls']} "
                                 f"against cold "
                                 f"{out['store']['cold']['calls']}, tier "
                                 f"{out['disk_tier']}")
        step("5b restarted host", t0)

        # -- 6. SIGKILL the remote ----------------------------------------
        t0 = time.perf_counter()
        orphans = tenants_by_replica(ring)[FLEET_REMOTE_ID]
        stop, failed, lock = threading.Event(), [], threading.Lock()

        def knock():
            # the remote's tenants, through the router, until suspended
            k = 0
            while not stop.is_set():
                try:
                    lookup_on(fleet.address, orphans[k % len(orphans)],
                              [k], follow=False)
                except Exception as e:    # noqa: BLE001 -- counted
                    with lock:
                        failed.append(repr(e))
                k += 1
        knocker = threading.Thread(target=knock, daemon=True)
        remote.kill()
        t_kill = time.perf_counter()
        knocker.start()
        limit_s = 4 * FLEET_HEALTH_MS / 1000.0 + 1.0
        while True:
            status, topo = http_json(fleet.address, "/topology")
            if FLEET_REMOTE_ID in topo["suspended"]:
                break
            if time.perf_counter() - t_kill > 30.0:
                break
            time.sleep(0.02)
        suspend_s = time.perf_counter() - t_kill
        stop.set()
        knocker.join(timeout=60)
        out["suspend"] = {"s": suspend_s, "limit_s": limit_s,
                          "errors_5xx": len(failed),
                          "errors": sorted(set(e[:80] for e in failed))[:3]}
        # the router's 502 answers for a replica it cannot reach
        if suspend_s > limit_s or any("unreachable" not in e and
                                      "left the ring" not in e
                                      for e in failed):
            raise AssertionError(f"{name}: suspension {out['suspend']}")
        survivors = HashRing(
            [r for r in topo["replicas"] if r["id"] != FLEET_REMOTE_ID],
            topo["virtual_nodes"])
        for tenant in orphans:
            ids = rng.integers(0, rows, SERVE_BATCH)
            got, by = lookup_on(fleet.address, tenant, ids)
            oracle.check(f"{name} rehashed tenant", ids, got)
            if by != survivors.pick(tenant)["id"]:
                raise AssertionError(f"{name}: tenant {tenant} answered by "
                                     f"{by}")
        out["rehashed_tenants"] = len(orphans)
        step("6 remote killed, suspended", t0)

        # -- 7. the fleet's serving writer --------------------------------
        t0 = time.perf_counter()
        import pyarrow as pa
        wr = np.random.default_rng(5)
        res = {"batches": 0, "delta_read_s": 0.0, "commit_s": 0.0,
               "trace_context": []}

        def serving_writer():
            sw = fleet.new_serving_writer()
            try:
                for k in range(SERVE_WRITER_ROWS // SERVE_WRITER_BATCH):
                    live = np.flatnonzero(oracle.live)
                    ids = wr.choice(live, SERVE_WRITER_BATCH, replace=False)
                    v = wr.random(len(ids))
                    sw.write_arrow(pa.table({
                        "id": pa.array(ids, pa.int64()),
                        "v": pa.array(v, pa.float64()),
                        "name": pa.array(np.char.add(
                            f"w{k}-", (ids % 997).astype(str)))}))
                    oracle.upsert(ids, v, 100 + k)
                    t1 = time.perf_counter()
                    for s in fleet.servers:
                        for part in np.array_split(ids, 5):
                            got_, by = lookup_on(s.address, "w", part,
                                                 follow=False)
                            oracle.check(f"{name} writer batch {k} on "
                                         f"replica {by}", part, got_)
                    res["delta_read_s"] += time.perf_counter() - t1
                    t1 = time.perf_counter()
                    trace.enable_tracing()
                    try:
                        with trace.span("fleet.writer.commit", cat="serve"):
                            token = trace.current_context_token()
                            sid = sw.commit()
                    finally:
                        trace.disable_tracing()
                    res["commit_s"] += time.perf_counter() - t1
                    if sid is None:
                        raise AssertionError(f"{name}: writer batch {k} "
                                             f"committed nothing")
                    props = table.snapshot_manager.snapshot(sid).properties
                    if (props or {}).get("trace.context") != token:
                        raise AssertionError(f"{name}: snapshot {sid} "
                                             f"properties {props}, span "
                                             f"{token}")
                    res["trace_context"].append(token)
                    # every replica reloads its plan past the commit
                    # (the delta generation retires once all of them
                    # have), then the batch reads from the LSM
                    reload_plans(fleet)
                    part = ids[:1000]
                    got_, _ = lookup_on(fleet.address, "w", part)
                    oracle.check(f"{name} writer batch {k} after commit",
                                 part, got_)
                    res["batches"] += 1
                delta = fleet.servers[0].stats()["delta"]
                if delta["rows"]:
                    raise AssertionError(f"{name}: the delta tier holds "
                                         f"{delta} once every replica's "
                                         f"plan covers the commits")
            finally:
                sw.close()
        rec.run(name, "serving writer", SERVE_WRITER_ROWS, dev,
                serving_writer)
        res["launches"] = rec.phases[-1]["launches_plain"]
        res["trace_context"] = res["trace_context"][:1]
        out["writer"] = res
        if res["launches"] == 0:
            raise AssertionError(f"{name}: the writer's flushes launched no "
                                 f"K1")
        step("7 serving writer", t0)

        # -- 8. /scan, a full compaction under readers, /scan -------------
        t0 = time.perf_counter()
        limit = min(SERVE_SCAN_LIMIT, int(oracle.live.sum()))

        def bounded_scan():
            with KvQueryClient(address=fleet.address, tenant="scan",
                               follow_topology=False) as c:
                return c.scan(limit=limit)
        part = rec.run(name, "bounded scan", limit, dev, bounded_scan)
        oracle.check_scan(f"{name} bounded scan", part)
        scan_k1 = rec.phases[-1]["launches_plain"]
        if len(part) != limit or scan_k1 == 0:
            raise AssertionError(f"{name} bounded scan: {len(part)} rows, "
                                 f"{scan_k1} K1")
        t1 = time.perf_counter()
        old = data_paths(served())
        names = {p.rsplit("/", 1)[-1] for p in old}
        tier = shared_cache_state().disk
        # the SSD tier's entries of the files the compaction will drop,
        # read through the tier
        held = [p for p in old if tier.get(tier.file_key(p)) is not None]
        evictions0 = counter("cache_disk", CACHE_DISK_EVICTIONS)
        parts = {"plan and SSD reads": time.perf_counter() - t1}
        t1 = time.perf_counter()
        stop.clear()
        answers, errors = [], []

        def reader(seed):
            r = np.random.default_rng(2000 + seed)
            try:
                with KvQueryClient(address=fleet.address,
                                   tenant=f"t{seed}") as rc:
                    while not stop.is_set():
                        ids_ = r.integers(0, rows, SERVE_BATCH)
                        answers.append((ids_, rc.lookup(
                            [{"id": int(i)} for i in ids_])))
            except Exception as e:      # noqa: BLE001 -- raised below
                errors.append(repr(e))
        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(FLEET_READERS)]
        for t in threads:
            t.start()
        try:
            sid = rec.run(name, "compact", rows, dev,
                          lambda: served().copy({"write-only": "false"})
                          .compact(full=True))
            # the readers go on across the commit
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        compact_k1 = rec.phases[-1]["launches_plain"]
        parts["compaction under readers"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        if sid is None or errors or compact_k1 == 0:
            raise AssertionError(f"{name} compaction: snapshot {sid}, K1 "
                                 f"{compact_k1}, reader errors {errors[:3]}")
        for ids, got in answers:
            oracle.check(f"{name} during compaction", ids, got)
        # every replica reloads its plan: a replica still on the old
        # plan may have built an SST from a dropped file, re-reading it
        # into the tiers, after another's reload evicted it
        reload_plans(fleet)
        ids = rng.integers(0, rows, SERVE_BATCH)
        got, _ = lookup_on(fleet.address, "w", ids)
        oracle.check(f"{name} after compaction", ids, got)
        evicted = counter("cache_disk", CACHE_DISK_EVICTIONS) - evictions0
        state = shared_cache_state()
        with state.lock:
            cached = [p for p in state.cache if p in old] + \
                [k[0] for k in state.ranges if k[0] in old]
        cached += [p for p in old if tier.get(tier.file_key(p)) is not None]
        stale = [k for s in fleet.servers for k in s.query().store.keys()
                 if any(f in k for f in names)]
        if not held or evicted < len(held) or cached or stale:
            raise AssertionError(f"{name}: of {len(held)} SSD entries of "
                                 f"compacted-away files {evicted} evicted; "
                                 f"still cached {cached[:3]} or served "
                                 f"{stale[:3]}")
        parts["reads checked, reloads, eviction checks"] = \
            time.perf_counter() - t1
        t1 = time.perf_counter()
        again = bounded_scan()
        oracle.check_scan(f"{name} bounded scan after compaction", again)
        parts["bounded scan after"] = time.perf_counter() - t1
        out["compaction"] = {"reads": len(answers),
                             "s": rec.phases[-1]["s"], "k1": compact_k1,
                             "dropped_files": len(old),
                             "ssd_entries_dropped": len(held),
                             "ssd_evictions": evicted, "steps_s": parts}
        out["bounded_scan"] = {"rows": limit, "k1": scan_k1,
                               "s": next(p["s"] for p in rec.phases
                                         if p["table"] == name and
                                         p["phase"] == "bounded scan")}
        step("8 scan, compaction under readers", t0)

        # -- 9. hedged and unhedged scans of the whole table ---------------
        t0 = time.perf_counter()
        scans = {}
        sm = table.snapshot_manager
        small = [sm.snapshot_path(i) for i in range(
            sm.earliest_snapshot_id(), sm.latest_snapshot_id() + 1)]
        large = sorted(data_paths(served()) | old)

        def hedge_counts():
            return {k: counter("resilience", m) for k, m in (
                ("issued", RESILIENCE_HEDGES_ISSUED),
                ("won", RESILIENCE_HEDGES_WON),
                ("abandoned", RESILIENCE_HEDGES_ABANDONED))}

        def hedgeable(calls):
            return sum(calls["calls"][k] for k in ("get", "head", "list"))
        for hedge in ("false", "true"):
            s_store, s_fio = fleet_store(root)
            t = FileStoreTable.load(path, file_io=s_fio, device=device,
                                    dynamic_options={
                                        "read.hedge.enabled": hedge,
                                        "read.hedge.min-delay": "2",
                                        "store.breaker.enabled": "true"})
            h0, mark0 = hedge_counts(), s_store.mark()
            warm_latency_model(t.file_io, small, large, FLEET_HEDGE_WARMUP)
            # a GET that a hedge beat runs on to its end: the warm-up's
            # finish before the scan's counts start
            time.sleep(FLEET_STORE["base_ms"] * FLEET_STORE["tail_multiplier"]
                       / 1000.0)
            h1, mark = hedge_counts(), s_store.mark()
            t.file_io = timed = TimedReads(t.file_io)
            got = rec.run(name, f"scan hedge={hedge}", out["live"], dev,
                          t.to_arrow)
            h2 = hedge_counts()
            calls, total = s_store.since(mark), s_store.since(mark0)
            # every hedge is one more call on the store
            issued = h2["issued"] - h1["issued"]
            life = {k: h2[k] - h0[k] for k in h2}
            scans[hedge] = {
                "s": rec.phases[-1]["s"],
                "read_p50_ms": pct(timed.ms, 50),
                "read_p99_ms": pct(timed.ms, 99),
                "store": calls, "hedges": issued,
                "hedgeable": hedgeable(calls) - issued,
                "store_life": {"gets": total["calls"]["get"],
                               "get_p50_ms": total["get_p50_ms"],
                               "get_p99_ms": total["get_p99_ms"],
                               "injected_tails":
                                   s_store.inner.stats["tail_hits"],
                               "hedges": life,
                               "hedgeable": hedgeable(total)
                               - life["issued"]},
                "table": got.sort_by("id")}
            life["ratio"] = life["issued"] / max(
                1, scans[hedge]["store_life"]["hedgeable"])
            cap = t.options.get(CoreOptions.READ_HEDGE_MAX_RATIO)
        hedged = scans["true"]["store_life"]["hedges"]
        # the hedged store's latency model fired hedges at its GET tail,
        # a hedge beat its primary, and the hedges stayed inside the cap
        # of read.hedge.max-ratio
        if not scans["false"]["table"].equals(scans["true"]["table"]) or \
                scans["false"]["store_life"]["hedges"]["issued"] or \
                hedged["issued"] == 0 or hedged["won"] == 0 or \
                hedged["ratio"] > cap:
            raise AssertionError(f"{name}: hedged scan rows differ, or "
                                 f"hedges {hedged} against the cap {cap} "
                                 f"(unhedged store "
                                 f"{scans['false']['store_life']})")
        check_fleet_table(f"{name} scan", oracle, scans["true"]["table"])
        for s in scans.values():
            del s["table"]
        out["scans"] = scans
        step("9 hedged and unhedged scans", t0)

        # -- 10. a stalled store under a 200 ms deadline -------------------
        t0 = time.perf_counter()
        _, stuck_fio = fleet_store(root, stuck_rate=1.0,
                                   stuck_ms=FLEET_STUCK_MS)
        stuck = FileStoreTable(stuck_fio, path, table.schema, {
            "request.timeout": f"{FLEET_DEADLINE_MS} ms",
            "read.hedge.enabled": "true"}, device=device)
        t1 = time.perf_counter()
        try:
            stuck.to_arrow()
            raise AssertionError(f"{name}: the stalled read returned")
        except DeadlineExceededError:
            deadline_s = time.perf_counter() - t1
        if deadline_s > 1.0:
            raise AssertionError(f"{name}: the deadline error came after "
                                 f"{deadline_s:.2f} s")
        _, plain_fio = fleet_store(root)
        after = FileStoreTable(plain_fio, path, table.schema, {
            "request.timeout": "30 s"}, device=device).to_arrow(
                limit=10_000)
        oracle.check_scan(f"{name} read after the stall",
                          after.to_pylist())
        out["deadline"] = {"timeout_ms": FLEET_DEADLINE_MS,
                           "raised_after_s": deadline_s,
                           "next_read_rows": after.num_rows}
        step("10 deadline", t0)

        # -- 11. the fleet's SLO --------------------------------------------
        t0 = time.perf_counter()
        status, slo = http_json(fleet.address, "/slo")
        if status != 200 or not slo.get("router") or \
                slo["replicas"] != FLEET_REPLICAS or \
                slo["unreachable"] != [str(FLEET_REMOTE_ID)] or \
                set(slo["objectives"]) != {"availability", "latency"}:
            raise AssertionError(f"{name}: /slo {slo}")
        out["slo"] = {k: slo[k] for k in ("replicas", "unreachable", "alert",
                                          "objectives", "good_events",
                                          "bad_events")}
        step("11 slo", t0)
        fleet.stop()
        sets.remove(fleet)
    finally:
        for s in sets:
            s.stop()
        remote.stop()
        restart.stop()
        reset_delta_tiers()
        reset_disk_tiers()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ssd, ignore_errors=True)
    out["native_probes"] = counter("lookup", LOOKUP_NATIVE_PROBES) - probes0
    out["native_fallbacks"] = \
        counter("lookup", LOOKUP_NATIVE_FALLBACKS) - fallbacks0
    if out["native_probes"] <= 0 or out["native_fallbacks"]:
        raise AssertionError(f"{name}: native probes {out['native_probes']}, "
                             f"fallbacks {out['native_fallbacks']}")
    out["k1_by_thread"] = {t: n[0] for t, n in
                           thread_launches(rec.capture, name).items()}
    out["launches"] = {p["phase"]: p["launches_plain"] for p in rec.phases
                       if p["table"] == name}
    out["peak_gib"] = {p["phase"]: p["peak_gib"] for p in rec.phases
                       if p["table"] == name}
    out["s"] = time.perf_counter() - t_phase
    return out


class DecodeTimer:
    """Seconds the device decode plane spends in each of its four steps
    (format/rawpage.py): host parse and decompression, the upload, the
    device expansion and the download.  For as long as it is entered it
    wraps the four step functions, synchronising the card before and
    after each call; scan threads overlap, so the sums can exceed the
    time they cover."""

    STEPS = {"_plan_chunk": "host_parse_s", "_upload_chunk": "upload_s",
             "_expand_chunk": "expand_s", "_download_chunk": "download_s"}

    def __init__(self):
        self.seconds = dict.fromkeys(self.STEPS.values(), 0.0)
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.seconds)

    def delta(self, before: dict) -> dict:
        now = self.snapshot()
        return {k: now[k] - before[k] for k in now}

    def _timed(self, field: str, fn):
        import torch

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            with self._lock:
                self.seconds[field] += time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        from paimon_tpu_torch.format import rawpage
        self._module = rawpage
        self._fns = {name: getattr(rawpage, name) for name in self.STEPS}
        for name, field in self.STEPS.items():
            setattr(rawpage, name, self._timed(field, self._fns[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(self._module, name, fn)


def device_decode_dedup(path: str, rows: int, rec: Recorder, cols: dict,
                        win: np.ndarray, timer: DecodeTimer) -> dict:
    """dedup_bigint's directory as it stood after its 10 commits, loaded
    with read.device-decode=true: a merge-on-read scan, the streamed
    full compaction and a read back on the card, each held row for row
    against dedup_bigint's last-writer-wins oracle, with every file read
    through the device decode plane (no fallback) and the seconds of its
    four steps."""
    from paimon_tpu_torch.format import rawpage
    from paimon_tpu_torch.table import FileStoreTable

    name = "device_decode_dedup"
    table = FileStoreTable.load(path, dynamic_options={
        "read.device-decode": "true"})
    rawpage.DECODE_COUNTS.update(files=0, fallbacks=0)
    out = {}
    for what, fn in (("scan", table.to_arrow),
                     ("compact", lambda: table.compact(full=True)),
                     ("read", table.to_arrow)):
        before, files = timer.snapshot(), rawpage.DECODE_COUNTS["files"]
        got = rec.run(name, what, rows, table.device, fn)
        out[what] = {"rows_per_s": rec.phases[-1]["rows_per_s"],
                     "s": rec.phases[-1]["s"],
                     "files": rawpage.DECODE_COUNTS["files"] - files,
                     **timer.delta(before)}
        if what == "compact":
            if got is None:
                raise AssertionError(f"{name}: the full compaction "
                                     f"committed nothing")
        else:
            check_rows(f"{name} {what}", got, cols, win, "id")
        del got
    counts = dict(rawpage.DECODE_COUNTS)
    if counts["files"] == 0 or counts["fallbacks"] != 0:
        raise AssertionError(f"{name}: decode counts {counts}")
    out["decode_counts"] = counts
    for what, split in out.items():
        if what != "decode_counts":
            log(f"  {name} {what}: {split['files']} files through the "
                f"device decode plane; host parse and decompression "
                f"{split['host_parse_s']:.2f} s, upload "
                f"{split['upload_s']:.2f} s, device expand "
                f"{split['expand_s']:.2f} s, download "
                f"{split['download_s']:.2f} s (summed over threads)")
    shutil.rmtree(path, ignore_errors=True)
    return out


def device_decode_coverage(work: str, rows: int = 1 << 18,
                           seed: int = 29, device: str = "cuda") -> dict:
    """read_parquet_device on the card against pyarrow on ~1M rows of
    INT32, INT64, FLOAT, DOUBLE and DATE columns (dictionary pages on,
    1 value in 8 null, 4 row groups a file, several pages a chunk), a
    string-keyed table that must fall back (counted) and read the same,
    and fused_decode_merge at 2^22 on the card against its CPU run (cut
    from 4M rows and 2^24 for the script's time)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.format import rawpage
    from paimon_tpu_torch.fs import LocalFileIO
    from paimon_tpu_torch.ops.decode import fused_decode_merge
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, VarCharType

    rng = np.random.default_rng(seed)
    fio = LocalFileIO()
    rawpage.DECODE_COUNTS.update(files=0, fallbacks=0)
    files = 4
    per = rows // files
    out = {"rows": rows, "decode_s": 0.0, "pyarrow_s": 0.0}
    for k in range(files):
        def col(values, typ):
            return pa.array(values, typ, mask=rng.random(per) < 0.125)
        table = pa.table({
            "i32": col(rng.integers(-1 << 31, 1 << 31, per).astype(np.int32),
                       pa.int32()),
            "i64": col(rng.integers(0, 1000, per), pa.int64()),
            "f32": col(rng.random(per).astype(np.float32), pa.float32()),
            "f64": col(rng.integers(0, 50, per) / 4.0, pa.float64()),
            "day": col(rng.integers(0, 20_000, per).astype(np.int32),
                       pa.date32())})
        path = os.path.join(work, f"coverage-{k}.parquet")
        pq.write_table(table, path, compression="zstd",
                       row_group_size=per // 4, data_page_size=256 << 10)
        t0 = time.perf_counter()
        got = rawpage.read_parquet_device(fio, path, device=device)
        t1 = time.perf_counter()
        want = pq.read_table(path)
        out["decode_s"] += t1 - t0
        out["pyarrow_s"] += time.perf_counter() - t1
        if not got.equals(want):
            raise AssertionError(f"device_decode_coverage: file {k} differs "
                                 f"from pyarrow")
        os.unlink(path)
    if rawpage.DECODE_COUNTS != {"files": files, "fallbacks": 0}:
        raise AssertionError(f"device_decode_coverage: decode counts "
                             f"{rawpage.DECODE_COUNTS}")

    schema = (Schema.builder().column("name", VarCharType(nullable=False))
              .column("v1", BigIntType()).primary_key("name")
              .options({"bucket": "1", "read.device-decode": "true"})
              .build())
    t = FileStoreTable.create(os.path.join(work, "coverage-strings"), schema,
                              device=device)
    wb = t.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({
            "name": pa.array([f"key-{i}" for i in range(1 << 16)]),
            "v1": pa.array(np.arange(1 << 16), pa.int64())}))
        wb.new_commit().commit(w.prepare_commit())
    got = t.to_arrow()
    want = t.copy({"read.device-decode": "false"}).to_arrow()
    if not got.equals(want) or rawpage.DECODE_COUNTS["fallbacks"] != 1:
        raise AssertionError(f"device_decode_coverage: the string-keyed "
                             f"table did not fall back once and read the "
                             f"same ({rawpage.DECODE_COUNTS})")
    t.file_io.delete(t.path, recursive=True)

    n = 1 << 22
    keys = rng.integers(-1 << 40, 1 << 40, n // 2).repeat(2)
    rng.shuffle(keys)
    seq = rng.permutation(n).astype(np.int64)
    host = [torch.from_numpy(keys.view(np.uint8).copy()),
            torch.from_numpy(seq.view(np.uint8).copy()),
            torch.zeros(n, dtype=torch.int32)]
    card = fused_decode_merge(*(x.to(device) for x in host))
    cpu = fused_decode_merge(*host)
    for what, a, b in zip(("perm", "winner", "packed"), card, cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"fused_decode_merge at 2^22: {what} "
                                 f"card != cpu")
    out["decode_counts"] = dict(rawpage.DECODE_COUNTS)
    log(f"  device_decode_coverage: {files} files of {per} rows (INT32, "
        f"INT64, FLOAT, DOUBLE, DATE; dictionary on, 1 in 8 null) equal to "
        f"pyarrow, no fallback (card {out['decode_s']:.2f} s, pyarrow "
        f"{out['pyarrow_s']:.2f} s); the string-keyed table fell back once "
        f"and read the same; fused_decode_merge at 2^22: card == cpu")
    return out


def route_inputs(n: int, runs: int = 10, seed: int = 37):
    """The main path's merge shapes: packed BIGINT keys (ids uniform in
    [0, n/2), bench.py's duplicate ratio) in `runs` (key, seq)-sorted
    runs, oldest first: (lanes u32[n, 2], seq, packed u64, run_starts)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(n // 2, 1), n)
    starts = np.linspace(0, n, runs + 1).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        ids[a:b] = np.sort(ids[a:b])
    packed = ids.view(np.uint64) ^ np.uint64(1 << 63)
    lanes = np.stack([(packed >> np.uint64(32)).astype(np.uint32),
                      (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)
    return lanes, np.arange(n, dtype=np.int64), packed, starts


# route: (switches, winners_only, pass packed, pass run_starts, full order)
ROUTES = {
    "device full": (("PAIMON_FORCE_DEVICE_SORT",), False, True, False, True),
    "device full, run codes": (("PAIMON_FORCE_DEVICE_SORT",), False, True,
                               True, True),
    "device packed": (("PAIMON_FORCE_DEVICE_SORT",), True, True, False,
                      False),
    "bitmask": (("PAIMON_FORCE_BITMASK_SORT",), True, True, False, False),
    "host native fast": (("PAIMON_FORCE_HOST_SORT",), True, True, False,
                         False),
    "host numpy fast": (("PAIMON_FORCE_HOST_SORT", "PAIMON_DISABLE_NATIVE"),
                        True, True, False, False),
    "host general": (("PAIMON_FORCE_HOST_SORT",), False, False, False, True),
    "host ovc": (("PAIMON_FORCE_HOST_SORT",), False, True, True, True),
}
ROUTE_SWITCHES = ("PAIMON_FORCE_DEVICE_SORT", "PAIMON_FORCE_HOST_SORT",
                  "PAIMON_FORCE_BITMASK_SORT", "PAIMON_DISABLE_NATIVE",
                  "PAIMON_DISABLE_OVC")
HOST_GENERAL_MAX = 1 << 22


class switched:
    """Sets the given routing switches for the length of a block."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in ROUTE_SWITCHES}
        for name in self.names:
            os.environ[name] = "1"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def model_pick(n: int, overlapped: bool) -> str:
    """The route device_sorted_winners' cost model takes for a
    winners-only merge of `n` packed BIGINT keys on the card."""
    from paimon_tpu_torch.ops import merge
    if merge._bitmask_device_pays(n, 2, overlapped):
        return "bitmask"
    return "device" if merge._device_path_pays(n, 2, True, True) \
        else "host"


def measure_constants(dev) -> dict:
    """The cost model's rates on this machine: the device's sort passes
    plus the winner-select kernel on resident data (2 lanes, 2^24), and
    the host's C radix fast route, numpy argsort fast route and general
    lexsort route at 2^20 (2^22 until the lake phase came), each the best
    of 3 host-clock runs."""
    import torch

    from paimon_tpu_torch.ops import merge

    def best(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times)

    n = 1 << 24
    lanes, seq, packed, _ = route_inputs(n)
    args = merge._upload(lanes, seq, None, packed, dev)
    out = {"device_sort_rows_per_s": n / best(
        lambda: merge.segmented_merge_body(*args, "last", 2))}
    del args
    m = 1 << 20
    lanes, seq, packed, _ = route_inputs(m)
    out["host_fast_native_rows_per_s"] = m / best(
        lambda: merge._host_sorted_winners_fast(lanes, seq, "last", packed))
    with switched("PAIMON_DISABLE_NATIVE"):
        out["host_fast_numpy_rows_per_s"] = m / best(
            lambda: merge._host_sorted_winners_fast(lanes, seq, "last",
                                                    packed))
    out["host_general_rows_per_s"] = m / best(
        lambda: merge._host_sorted_winners(lanes, seq, "last", 2))
    log("cost-model rates measured here: " + ", ".join(
        f"{k} {v:,.0f}" for k, v in out.items()))
    return out


def merge_routes(dedup_winner_frac: float, device: str = "cuda",
                 shapes=(14, 20)) -> dict:
    """Every route of device_sorted_winners at the main path's merge
    shapes (2 lanes, packed BIGINT keys, 10 sorted runs) at 2^14 and
    2^20 (2^22 too until the formats phase came, 2^24 until an earlier
    cut): the same winner rows
    in key order on every route, and the full routes also the same perm
    and prev on the real rows; each route timed on the host clock (best
    of 3, one run at 2^24 on the host routes), the measured link rates
    at 8 MiB (the model's) and 256 MiB, and the model's pick at each
    shape, at the winner fraction 1.0 of a fresh process and at the
    dedup table's."""
    import torch

    from paimon_tpu_torch import native
    from paimon_tpu_torch.ops import merge

    if native.load() is None:
        raise AssertionError("merge_routes: the native library did not load")
    dev = torch.device(device)
    links = {f"{size >> 20}MiB": merge.link_bandwidth(dev, size)
             for size in (8 << 20, 256 << 20)}
    for k, (h2d, d2h) in links.items():
        log(f"link at {k}: host to device {h2d / 1e9:.2f} GB/s, device to "
            f"host {d2h / 1e9:.2f} GB/s (pageable)")
    saved = (merge._LINK_BW, dict(merge._WINNER_FRAC))
    merge._LINK_BW = links["8MiB"]
    out = {"links": links, "constants": measure_constants(dev),
           "shapes": {}}
    for log2 in shapes:
        n = 1 << log2
        lanes, seq, packed, starts = route_inputs(n)
        picks = {}
        for frac_name, frac in (("1.0", None),
                                ("dedup", dedup_winner_frac)):
            merge._WINNER_FRAC.update(
                num=0.0 if frac is None else frac * n,
                den=0.0 if frac is None else float(n))
            for overlapped in (False, True):
                picks[f"frac {frac_name}, overlapped {overlapped}"] = \
                    model_pick(n, overlapped)
        times, winners, full = {}, {}, {}
        for route, (switches, winners_only, with_packed, with_runs,
                    full_order) in ROUTES.items():
            if route == "host general" and n > HOST_GENERAL_MAX:
                continue
            reps = 1 if n >= 1 << 24 and route.startswith("host") else 3
            best = None
            with switched(*switches):
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    perm, winner, prev = merge.device_sorted_winners(
                        lanes, seq, "last", winners_only=winners_only,
                        packed=packed if with_packed else None,
                        run_starts=starts if with_runs else None,
                        device=dev)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
            times[route] = best
            real = perm < n
            winners[route] = perm[winner & real]
            if full_order:
                full[route] = (perm[real], np.asarray(prev)[real])
        first = winners["device packed"]
        for route, w in winners.items():
            if not np.array_equal(w, first):
                raise AssertionError(f"merge_routes n=2^{log2}: {route}'s "
                                     f"winners differ from device packed's")
        base = full["device full"]
        for route, (p, q) in full.items():
            if not (np.array_equal(p, base[0]) and np.array_equal(q, base[1])):
                raise AssertionError(f"merge_routes n=2^{log2}: {route}'s "
                                     f"perm or prev differs from device "
                                     f"full's")
        out["shapes"][f"2^{log2}"] = {"seconds": times, "model": picks}
        log(f"merge routes at n=2^{log2} ({len(first)} winners): equal on "
            f"every route; " + ", ".join(f"{r} {t * 1e3:.2f} ms"
                                         for r, t in times.items())
            + "; model picks " + ", ".join(f"{k}: {v}"
                                           for k, v in picks.items()))
    merge._LINK_BW, frac = saved
    merge._WINNER_FRAC.update(frac)
    return out


# the 100M-row tables: none of their merge phases may take host routes only
# -- CDC ingest and the streaming daemon -------------------------------------

STREAM_EVENTS = 2_000_000        # stream_orders_2M: a snapshot of 1M `r`
STREAM_SNAPSHOT = 1_000_000      # events, then 1M changes over live ids
STREAM_SHARES = (0.6, 0.3, 0.1)  # u (before and after), c of new ids, d
STREAM_CHUNK = 62_500            # lines appended while the backlog is under
STREAM_KILL_AFTER = 1_000_000    # the kill, once the committed offset passes
STREAM_STATUSES = ("CREATED", "PAID", "SHIPPED", "DELIVERED", "CANCELLED")
STREAM_TS0 = 1_717_200_000_000   # updated_at of the first event (epoch ms)
STREAM_DB_EVENTS = 1 << 13       # database sync: each of 3 tables (2^14
                                 # until the search phase came)
STREAM_FORMAT_EVENTS = 1 << 12   # canal, maxwell, ogg, dms, aliyun each
STREAM_CLI_EVENTS = 1 << 14      # the `table stream` process's file
STREAM_AGG_EVENTS = 1 << 16      # the aggregation table fed by CDC
STREAM_FORMATS = ("canal", "maxwell", "ogg", "dms", "aliyun")
STREAM_COLS = ("customer_id", "status", "amount", "quantity", "updated_at")


def order_schema(options, extra=()):
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import (
        BigIntType, DoubleType, IntType, VarCharType,
    )
    b = (Schema.builder().column("order_id", BigIntType(False))
         .column("customer_id", BigIntType())
         .column("status", VarCharType.string_type())
         .column("amount", DoubleType()).column("quantity", IntType())
         .column("updated_at", BigIntType()))
    for name, typ in extra:
        b = b.column(name, typ)
    return b.primary_key("order_id").options(options).build()


def _order_images(prefix: str, ver, key, cust, status, amount, qty,
                  ts) -> list:
    """`prefix` + each row image's JSON (an empty string where `ver` is
    -1)."""
    return [prefix + f'{{"order_id":{k},"customer_id":{c},"status":'
            f'"{STREAM_STATUSES[s]}","amount":{a!r},"quantity":{q},'
            f'"updated_at":{t}}}' if v >= 0 else ""
            for v, k, c, s, a, q, t in zip(ver, *(x.tolist() for x in (
                key, cust, status, amount, qty, ts)))]


def _render_orders(op, before: tuple, after: tuple) -> bytes:
    """The JSONL bytes of a run of Debezium events: `op` 3 r, 0 u, 1 c,
    2 d; `before` and `after` (version, order_id, customer_id, status
    code, amount, quantity, updated_at) arrays, version -1 where the
    event has no such image."""
    b = _order_images('"before":', before[0].tolist(), *before[1:])
    a = _order_images('"after":', after[0].tolist(), *after[1:])
    head = ('{"op":"u",', '{"op":"c","before":null,', '{"op":"d",',
            '{"op":"r","before":null,')
    tail = ('}', '}', ',"after":null}', '}')
    out = []
    for o, bb, aa in zip(op.tolist(), b, a):
        out.append(head[o] + bb + ("," if o == 0 else "") + aa + tail[o])
    return ("\n".join(out) + "\n").encode()


class OrderStream:
    """The orders table's change stream from `seed`: a snapshot of
    `snapshot` `r` events (ids 0..snapshot-1), then `events - snapshot`
    changes, 60% `u` with before and after images, 30% `c` of new ids
    and 10% `d`, each `u` and `d` on an id drawn uniformly from the live
    ones.  Each event's images are row versions: `before` and `after`
    hold each event's (-1: none), `final` each id's last (-1:
    deleted)."""

    def __init__(self, events: int, snapshot: int, seed: int = 7):
        rng = np.random.default_rng(seed)
        changes = events - snapshot
        ops = rng.choice(3, size=changes, p=STREAM_SHARES)   # u, c, d
        picks = rng.random(changes).tolist()
        n_ver = snapshot + int((ops != 2).sum())
        self.cust = rng.integers(0, 1 << 24, n_ver)
        self.status = rng.integers(0, len(STREAM_STATUSES), n_ver)
        self.amount = np.round(rng.random(n_ver) * 1000.0, 2)
        self.quantity = rng.integers(1, 100, n_ver)
        ver_key = list(range(snapshot)) + [0] * (n_ver - snapshot)
        ver_event = list(range(snapshot)) + [0] * (n_ver - snapshot)
        cur = list(range(snapshot)) + [-1] * int((ops == 1).sum())
        live = list(range(snapshot))
        pos = list(range(snapshot)) + [-1] * int((ops == 1).sum())
        before = [-1] * changes
        after = [-1] * changes
        next_id, next_ver = snapshot, snapshot
        for i, (op, u) in enumerate(zip(ops.tolist(), picks)):
            if op == 1:                              # c: a new id
                k = next_id
                next_id += 1
                pos[k] = len(live)
                live.append(k)
            else:
                k = live[int(u * len(live))]
                before[i] = cur[k]
            if op == 2:                              # d
                j = pos[k]
                last = live.pop()
                if last != k:
                    live[j] = last
                    pos[last] = j
                cur[k] = -1
                continue
            ver_key[next_ver] = k
            ver_event[next_ver] = snapshot + i
            after[i] = next_ver
            cur[k] = next_ver
            next_ver += 1
        self.key = np.asarray(ver_key, dtype=np.int64)
        self.ts = STREAM_TS0 + np.asarray(ver_event, dtype=np.int64)
        self.op = np.concatenate([np.full(snapshot, 3, np.int8),
                                  ops.astype(np.int8)])
        self.before = np.concatenate([np.full(snapshot, -1, np.int64),
                                      np.asarray(before, np.int64)])
        self.after = np.concatenate([np.arange(snapshot, dtype=np.int64),
                                     np.asarray(after, np.int64)])
        self.events = events
        self.change_rows = events + int((ops == 0).sum())
        self.final = np.asarray(cur, dtype=np.int64)
        self.ids = np.flatnonzero(self.final >= 0)

    def _images(self, ver: np.ndarray) -> tuple:
        v = np.maximum(ver, 0)
        return (ver, self.key[v], self.cust[v], self.status[v],
                self.amount[v], self.quantity[v], self.ts[v])

    def columns(self) -> dict:
        """The oracle: each live id's last values, ids ascending."""
        v = self.final[self.ids]
        return {"order_id": self.ids.astype(np.int64),
                "customer_id": self.cust[v], "status": self.status[v],
                "amount": self.amount[v], "quantity": self.quantity[v],
                "updated_at": self.ts[v]}


_GENERATING: dict = {}            # generate_orders' stream, for its workers


def _render_span(span) -> None:
    stream, out = _GENERATING["stream"], _GENERATING["out"]
    k, lo, hi = span
    with open(os.path.join(out, f"chunk-{k}"), "wb") as f:
        f.write(_render_orders(stream.op[lo:hi],
                               stream._images(stream.before[lo:hi]),
                               stream._images(stream.after[lo:hi])))


def generate_orders(out: str, events: str, snapshot: str,
                    chunk: str) -> None:
    """OrderStream's events as JSONL chunks of `chunk` lines
    (`out`/chunk-K) and its oracle (`out`/oracle.npz, `out`/meta.json);
    run as a process of its own (OrderEvents)."""
    import multiprocessing

    t0 = time.perf_counter()
    events, snapshot, chunk = int(events), int(snapshot), int(chunk)
    stream = OrderStream(events, snapshot)
    spans = [(k, lo, min(lo + chunk, events))
             for k, lo in enumerate(range(0, events, chunk))]

    # this process has no thread and no CUDA context: fork's workers
    # inherit the stream's arrays
    _GENERATING.update(stream=stream, out=out)
    with multiprocessing.get_context("fork").Pool(4) as pool:
        pool.map(_render_span, spans)
    sizes = [hi - lo for _, lo, hi in spans]
    np.savez(os.path.join(out, "oracle.npz"), **stream.columns())
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump({"chunks": sizes, "change_rows": stream.change_rows,
                   "live_ids": int(len(stream.ids)),
                   "ids": int(len(stream.final)),
                   "s": time.perf_counter() - t0}, f)


class OrderEvents:
    """generate_orders in a process of this script, started ahead of
    the cell so its seconds overlap other work."""

    def __init__(self, work: str, events: int, snapshot: int, chunk: int):
        root = os.path.dirname(os.path.abspath(__file__))
        self.out = os.path.join(work, "order-events")
        os.makedirs(self.out)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.generate_orders(*sys.argv[1:])", self.out,
             str(events), str(snapshot), str(chunk)], cwd=root,
            env=dict(os.environ, PYTHONPATH=root))

    def wait(self) -> tuple:
        """(meta, oracle columns, [(lines, chunk path)])."""
        if self.proc.wait() != 0:
            raise AssertionError(f"generating the events: exit "
                                 f"{self.proc.returncode}")
        with open(os.path.join(self.out, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(self.out, "oracle.npz")) as z:
            want = {k: z[k] for k in z.files}
        return meta, want, [(n, os.path.join(self.out, f"chunk-{k}"))
                            for k, n in enumerate(meta["chunks"])]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class Materialized:
    """A changelog consumer's state: +I and +U set an id's values, -D
    drops it, -U changes nothing; a batch applies at once, each id's
    last row deciding (an id's rows keep their order in a changelog)."""

    def __init__(self, ids: int):
        self.present = np.zeros(ids, dtype=bool)
        self.cols = {c: np.zeros(ids, dtype=np.float64 if c == "amount"
                                 else np.int64) for c in STREAM_COLS}
        self.rows = 0
        self._code = {s: i for i, s in enumerate(STREAM_STATUSES)}

    def apply(self, rows: list) -> None:
        from operator import itemgetter

        from paimon_tpu_torch.core.read import ROW_KIND_COL
        kind = np.array(list(map(itemgetter(ROW_KIND_COL), rows)), np.int8)
        keep = np.flatnonzero(kind != 1)
        self.rows += len(rows)
        if not len(keep):
            return
        ids = np.array(list(map(itemgetter("order_id"), rows)),
                       np.int64)[keep]
        # each id's last row in the batch
        rev = ids[::-1]
        _, first = np.unique(rev, return_index=True)
        sel = keep[len(keep) - 1 - first]
        ids = ids[len(keep) - 1 - first]
        delete = kind[sel] == 3
        self.present[ids] = ~delete
        up, up_sel = ids[~delete], sel[~delete]
        chosen = list(map(rows.__getitem__, up_sel.tolist()))
        for c in STREAM_COLS:
            vals = list(map(itemgetter(c), chosen))
            if c == "status":
                vals = list(map(self._code.__getitem__, vals))
            self.cols[c][up] = np.asarray(vals, dtype=self.cols[c].dtype)

    def check(self, what: str, want: dict) -> None:
        got = np.flatnonzero(self.present)
        if not np.array_equal(got, want["order_id"]):
            raise AssertionError(f"{what}: {len(got)} live ids, "
                                 f"{len(want['order_id'])} expected")
        for c in STREAM_COLS:
            if not np.array_equal(self.cols[c][got], want[c]):
                raise AssertionError(f"{what}: column {c} differs")


def check_orders(what: str, got, want: dict) -> None:
    """The table read against the oracle, row for row by id."""
    ids = got.column("order_id").to_numpy()
    order = np.argsort(ids, kind="stable")
    if not np.array_equal(ids[order], want["order_id"]):
        raise AssertionError(f"{what}: {len(ids)} rows, "
                             f"{len(want['order_id'])} expected")
    import pyarrow as pa
    import pyarrow.compute as pc
    for c in STREAM_COLS:
        col = got.column(c)
        if c == "status":
            vals = pc.index_in(col, value_set=pa.array(
                STREAM_STATUSES)).to_numpy(zero_copy_only=False)
        else:
            vals = col.to_numpy()
        if not np.array_equal(vals[order], want[c]):
            raise AssertionError(f"{what}: column {c} differs")


# a second consumer in a process of its own: the query service on the
# same table (on the card) answering its /changelog polls; it writes its
# materialised state when the parent's "done" file exists and a poll
# comes back caught up
STREAM_REMOTE_CONSUMER = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
from paimon_tpu_torch.service.query_service import (
    KvQueryClient, KvQueryServer)
from paimon_tpu_torch.table import FileStoreTable
path, out, device, ids = sys.argv[1], sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
t0 = time.perf_counter()
table = FileStoreTable.load(path, device=device)
server = KvQueryServer(table).start()
client = KvQueryClient(address=server.address)
state = cs.Materialized(ids)
ready = time.perf_counter() - t0
polls = 0
try:
    while True:
        done = os.path.exists(out + ".done")
        got = client.changelog(consumer="orders-remote", max_rows=131072)
        polls += 1
        if got["rows"]:
            state.apply(got["rows"])
        elif got["caught_up"]:
            if done:
                break
            time.sleep(0.05)
    np.savez(out, present=state.present,
             **{c: state.cols[c] for c in cs.STREAM_COLS})
    with open(out + ".tmp", "w") as f:
        json.dump({"ready_s": ready, "polls": polls, "rows": state.rows,
                   "s": time.perf_counter() - t0}, f)
    os.replace(out + ".tmp", out + ".json")
finally:
    server.stop()
"""


class RemoteConsumer:
    """STREAM_REMOTE_CONSUMER as a process, from the checkout's root."""

    def __init__(self, path: str, out: str, dev, ids: int):
        root = os.path.dirname(os.path.abspath(__file__))
        self.out = out
        self.proc = subprocess.Popen(
            [sys.executable, "-c", STREAM_REMOTE_CONSUMER, path, out,
             dev.type, str(ids)], cwd=root,
            env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def ended(self) -> None:
        """Tell it the stream ended: it stops at its next caught-up
        poll."""
        with open(self.out + ".done", "w"):
            pass

    def finish(self, ids: int, want: dict, timeout: float = 120.0) -> dict:
        """Wait for its state (after `ended`; its exit is `stop`'s) and
        hold it against `want`; returns what it reports."""
        deadline = time.perf_counter() + timeout
        while not os.path.exists(self.out + ".json"):
            if self.proc.poll() is not None or \
                    time.perf_counter() > deadline:
                self.stop()
                raise AssertionError(f"the /changelog consumer: exit "
                                     f"{self.proc.returncode}: "
                                     f"{self.proc.stderr.read()[-800:]}")
            time.sleep(0.02)
        state = Materialized(ids)
        with np.load(self.out + ".npz") as z:
            state.present = z["present"]
            state.cols = {c: z[c] for c in STREAM_COLS}
        state.check("the /changelog consumer", want)
        with open(self.out + ".json") as f:
            return json.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


def stream_orders(work: str, rec: Recorder, dev, scale: int,
                  gen: OrderEvents) -> dict:
    """stream_orders_2M: 2M Debezium events tailed from a growing JSONL
    file by one StreamDaemon (ingest, compaction and serve loops), a
    kill after the committed offset passes 1M and a new daemon that
    recovers from the checkpoint; the table, an in-process consumer of
    poll_changelog and a /changelog consumer in a process of its own
    held against the oracle."""
    import torch

    from paimon_tpu_torch.cdc.source import FileCdcSource
    from paimon_tpu_torch.metrics import (
        STREAM_CHECKPOINT_MS, STREAM_CHECKPOINTS, STREAM_COMPACTIONS,
        STREAM_COMPACTIONS_PAUSED, STREAM_FRESHNESS_MS,
        STREAM_LOOP_RESTARTS, global_registry,
    )
    from paimon_tpu_torch.ops import kernels
    from paimon_tpu_torch.service.stream_daemon import (
        PROP_OFFSET, StreamDaemon,
    )
    from paimon_tpu_torch.table import FileStoreTable

    events, snapshot = STREAM_EVENTS // scale, STREAM_SNAPSHOT // scale
    kill_after, chunk = STREAM_KILL_AFTER // scale, STREAM_CHUNK // scale
    name = f"stream_orders_{events / 1e6:g}M"
    t0 = time.perf_counter()
    meta, want, chunks = gen.wait()
    ids = meta["ids"]
    out = {"events": events, "change_rows": meta["change_rows"],
           "live_ids": meta["live_ids"], "generate_s": meta["s"],
           "generate_wait_s": time.perf_counter() - t0}
    log(f"  {name}: {events} events ({meta['change_rows']} change rows, "
        f"{meta['live_ids']} live ids) made in {meta['s']:.2f} s in a "
        f"process of their own ({out['generate_wait_s']:.2f} s waited)")
    path = os.path.join(work, name)
    # the stream.* options at their defaults; stream.compaction.interval
    # 2 s is its default, stated
    table = FileStoreTable.create(path, order_schema({
        "bucket": "4", "changelog-producer": "input",
        "stream.compaction.interval": "2s"}), device=dev)
    events_path = path + ".jsonl"
    open(events_path, "wb").close()
    remote = RemoteConsumer(path, os.path.join(work, name + "-remote"),
                            dev, ids)
    try:
        g = global_registry().stream_metrics()
        base = {k: g.counter(k).count for k in (
            STREAM_CHECKPOINTS, STREAM_COMPACTIONS, STREAM_COMPACTIONS_PAUSED,
            STREAM_LOOP_RESTARTS)}
        holder = {"daemon": None}
        stop = threading.Event()
        marks = {}
        local = Materialized(ids)
        errors = []

        def produce():
            appended = 0
            try:
                with open(events_path, "ab") as f:
                    for n, chunk_path in chunks:
                        with open(chunk_path, "rb") as c:
                            data = c.read()
                        while not stop.is_set():
                            d = holder["daemon"]
                            pending = d.status()["offset_pending"] if d else -1
                            if appended - (pending + 1) < chunk:
                                break
                            time.sleep(0.02)
                        if stop.is_set():
                            return
                        f.write(data)
                        f.flush()
                        marks.setdefault("first_append", time.perf_counter())
                        appended += n
                marks["last_append"] = time.perf_counter()
            except Exception as e:                # noqa: BLE001 — reported
                errors.append(e)

        def consume():
            # the killed daemon's buffered tail first: the main thread hands
            # over the new daemon only after kill() has joined the old loops
            d = holder["daemon"]
            try:
                while True:
                    handed_over = holder["daemon"] is not d
                    rows = d.poll_changelog(max_rows=65536, timeout=0.2)
                    if rows:
                        local.apply(rows)
                    elif handed_over:
                        d = holder["daemon"]
                    elif stop.is_set() and not d._serve_alive():
                        return
            except Exception as e:                # noqa: BLE001 — reported
                errors.append(e)

        rec.capture.where = f"{name} stream"
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        launches0 = rec.counts()
        d1 = StreamDaemon(table, FileCdcSource(events_path))
        holder["daemon"] = d1
        producer = threading.Thread(target=produce, name="stream-producer")
        consumer = threading.Thread(target=consume, name="stream-consumer")
        d1.start()
        producer.start()
        consumer.start()
        rss = [rss_gib()]

        def wait(daemon, offset: int, what: str, timeout: float = 300.0):
            """Until `daemon` has committed past `offset - 1`; samples this
            process's resident set every 0.1 s meanwhile."""
            deadline = time.perf_counter() + timeout
            sampled = 0.0
            while daemon.status()["offset_committed"] < offset:
                if time.perf_counter() - sampled >= 0.1:
                    rss.append(rss_gib())
                    sampled = time.perf_counter()
                st = daemon.status()
                if errors or any(lp["failed"] for lp in st["loops"].values()) \
                        or time.perf_counter() > deadline:
                    raise AssertionError(f"{name}, {what}: {errors or st}")
                time.sleep(0.005)

        try:
            wait(d1, kill_after, "before the kill")
            t_kill = time.perf_counter()
            killed = d1.kill()
            off_kill = killed["offset_committed"]
            if off_kill >= events - 1:
                raise AssertionError(f"{name}: every event was committed "
                                     f"before the kill")
            d2 = StreamDaemon(FileStoreTable.load(path, device=dev),
                              FileCdcSource(events_path))
            holder["daemon"] = d2
            d2.start()
            wait(d2, off_kill + 1, "the recovery")
            out["recover_s"] = time.perf_counter() - t_kill
            out["kill_offset"] = off_kill
            wait(d2, events - 1, "after the recovery")
            t_end = time.perf_counter()
            status = d2.stop()
            # the drain: a final checkpoint, the serve loop's catch-up
            # and any compaction under way
            out["drain_s"] = time.perf_counter() - t_end
            remote.ended()
            stop.set()
            consumer.join(60)
            producer.join(10)
            if errors:
                raise errors[0]
        except BaseException:
            stop.set()
            for d in {id(x): x for x in (holder["daemon"], d1)}.values():
                d.kill()
            raise
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(rec.counts(), launches0))
        window = t_end - marks["first_append"]
        out.update({
            "events_per_s": events / window,
            "change_rows_per_s": meta["change_rows"] / window, "s": window,
            "appends_done_s": marks["last_append"] - marks["first_append"],
            "launches_plain": launched[0], "launches_ovc": launched[1]})
        rec.add(name, "stream", events, dev, window, launched)
        for lp, st in (("first", killed), ("second", status)):
            for loop, s in st["loops"].items():
                if s["failed"]:
                    raise AssertionError(f"{name}: the {lp} daemon's {loop} "
                                         f"loop ended for good: {s}")
        fresh = g.histogram(STREAM_FRESHNESS_MS)
        ckpt = g.histogram(STREAM_CHECKPOINT_MS)
        vals = fresh.window_values()
        out.update({
            "freshness_ms": {"p50": fresh.percentile(50),
                             "p95": fresh.percentile(95),
                             "max": max(vals) if vals else None,
                             "samples": fresh.total_count},
            "checkpoint_ms": {"p50": ckpt.percentile(50),
                              "p95": ckpt.percentile(95),
                              "samples": ckpt.total_count},
            **{k: g.counter(k).count - base[k] for k in base},
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
            "rss_gib": {"before": rss[0], "peak": max(rss)}})
        # the checks
        t0 = time.perf_counter()
        checks = {}
        local.check(f"{name} poll_changelog consumer", want)
        final = FileStoreTable.load(path, device=dev)
        got = rec.run(name, "read", meta["live_ids"], dev, final.to_arrow)
        check_orders(f"{name} table", got, want)
        checks["local_and_table_s"] = time.perf_counter() - t0
        offs, idents = [], []
        for snap in final.snapshot_manager.snapshots():
            if snap.commit_user == "stream-daemon" and \
                    PROP_OFFSET in (snap.properties or {}):
                offs.append(int(snap.properties[PROP_OFFSET]))
                idents.append(snap.commit_identifier)
        if offs != sorted(set(offs)) or offs[-1] != events - 1 or \
                off_kill not in offs:
            raise AssertionError(f"{name}: committed offsets {offs}")
        if idents != sorted(set(idents)):
            raise AssertionError(f"{name}: commit identifiers {idents}")
        t1 = time.perf_counter()
        report = final.fsck()
        if not report.ok:
            raise AssertionError(f"{name}: fsck: "
                                 f"{[v.to_dict() for v in report.violations]}")
        checks["fsck_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["remote"] = remote.finish(ids, want)
        checks["remote_s"] = time.perf_counter() - t1
        out.update({"checkpoint_offsets": len(offs),
                    "consumer_rows": local.rows, "checks": checks,
                    "check_s": time.perf_counter() - t0})
        out["k1_by_shape"] = sorted(
            [[k[1], k[2], k[3], k[4], v]
             for k, v in rec.capture.calls.items() if k[0] == name])
        out["k1_by_thread"] = sorted(
            [[k[1], k[2], v] for k, v in rec.capture.threads.items()
             if k[0] == name])
        log(f"  {name}: {out['events_per_s']:,.0f} events/s, "
            f"{out['change_rows_per_s']:,.0f} change rows/s over "
            f"{window:.2f} s; recovered in {out['recover_s']:.2f} s; "
            f"freshness {out['freshness_ms']}; checkpoints "
            f"{out[STREAM_CHECKPOINTS]}, compactions "
            f"{out[STREAM_COMPACTIONS]} (paused "
            f"{out[STREAM_COMPACTIONS_PAUSED]}), restarts "
            f"{out[STREAM_LOOP_RESTARTS]}; K1 {out['k1_by_shape']}")
    finally:
        remote.stop()
    os.remove(events_path)
    shutil.rmtree(path, ignore_errors=True)
    return out


# -- stream_coverage: database sync, formats, computed columns, an
#    aggregation table, crash recovery, flight dumps, the CLI, the merge

STREAM_NAMES = ("ada", "bo", "cy", "di", "ed", "flo", "gus", "hal")


def cdc_changes(seed: int, n: int, keys: int = 4096, wide_from=None,
                ts0=None) -> list:
    """n changes (op, before, after) of rows {id, name, amount, qty}:
    inserts of unseen ids, updates of live ones and 15% deletes.  From
    change `wide_from` on rows carry an unseen `city` column and `qty`
    values past INT; with `ts0` an `order_time` (epoch ms) column."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, keys, n).tolist()
    name = rng.integers(0, len(STREAM_NAMES), n).tolist()
    amount = np.round(rng.random(n) * 1000.0, 2).tolist()
    qty = rng.integers(1, 100, n).tolist()
    city = rng.integers(0, len(STREAM_NAMES), n).tolist()
    dele = (rng.random(n) < 0.15).tolist()
    live = {}
    out = []
    for i in range(n):
        k = key[i]
        row = {"id": k, "name": STREAM_NAMES[name[i]], "amount": amount[i],
               "qty": qty[i]}
        if ts0 is not None:                 # 8 days, a second apart
            row["order_time"] = ts0 + (k % 8) * 86_400_000 + k * 1000
        if wide_from is not None and i >= wide_from:
            row["city"] = STREAM_NAMES[city[i]].upper()
            row["qty"] = qty[i] << 33
        if k in live and dele[i]:
            out.append(("d", live.pop(k), None))
        elif k in live:
            out.append(("u", live[k], row))
            live[k] = row
        else:
            out.append(("c", None, row))
            live[k] = row
    return out


def cdc_render(fmt: str, op: str, before, after, meta=None) -> list:
    """One change as `fmt`'s envelopes (aliyun sends an update as two
    events); `meta` adds the source database and table."""
    meta = meta or {}
    row = after if op != "d" else before
    if fmt == "debezium":
        ev = {"op": op, "before": before, "after": after}
        if meta:
            ev["source"] = {"db": meta["database"], "table": meta["table"]}
            return [{"payload": ev}]
        return [ev]
    changed = {} if op != "u" else \
        {c: v for c, v in before.items() if after.get(c) != v}
    if fmt == "canal":
        ev = {"type": {"c": "INSERT", "u": "UPDATE", "d": "DELETE"}[op],
              "data": [row], **meta}
        if op == "u":
            ev["old"] = [changed]
        return [ev]
    if fmt == "maxwell":
        ev = {"type": {"c": "insert", "u": "update", "d": "delete"}[op],
              "data": row, **meta}
        if op == "u":
            ev["old"] = changed
        return [ev]
    if fmt == "ogg":
        ev = {"op_type": {"c": "I", "u": "U", "d": "D"}[op]}
        if before is not None:
            ev["before"] = before
        if after is not None:
            ev["after"] = after
        return [ev]
    if fmt == "dms":
        data = dict(row)
        data.update({f"BI_{c}": v for c, v in changed.items()})
        return [{"data": data, "metadata": {
            "record-type": "data",
            "operation": {"c": "insert", "u": "update",
                          "d": "delete"}[op]}}]
    if fmt == "aliyun":
        if op == "c":
            return [{"op": "INSERT", "payload": {"after": {
                "dataColumn": after}}}]
        if op == "d":
            return [{"op": "DELETE", "payload": {"before": {
                "dataColumn": before}}}]
        return [{"op": "UPDATE_BEFORE",
                 "payload": {"before": {"dataColumn": before}}},
                {"op": "UPDATE_AFTER",
                 "payload": {"after": {"dataColumn": after}}}]
    raise ValueError(fmt)


def cdc_oracle(changes: list, columns: list) -> list:
    """The rows the changes leave, by id, with `columns` (absent = null)."""
    live = {}
    for op, before, after in changes:
        if op == "d":
            live.pop(before["id"], None)
        else:
            live[after["id"]] = after
    return [{c: live[k].get(c) for c in columns} for k in sorted(live)]


def same_rows(what: str, table, want: list) -> None:
    got = sorted(table.to_arrow().to_pylist(), key=lambda r: r["id"])
    if got != want:
        raise AssertionError(f"{what}: {len(got)} rows, {len(want)} "
                             f"expected, or their values differ")


def cdc_schema(qty_int: bool = False, extra=(), partition=None):
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import (
        BigIntType, DoubleType, IntType, VarCharType,
    )
    b = (Schema.builder().column("id", BigIntType(False))
         .column("name", VarCharType.string_type())
         .column("amount", DoubleType())
         .column("qty", IntType() if qty_int else BigIntType()))
    for name, typ in extra:
        b = b.column(name, typ)
    if partition:
        b = b.partition_keys(partition).primary_key("id", partition)
    else:
        b = b.primary_key("id")
    return b.options({"bucket": "2"}).build()


def sink_events(table, fmt: str, events: list, commits: int = 2,
                computed=None):
    from paimon_tpu_torch.cdc import CdcSinkWriter
    sink = CdcSinkWriter(table, format=fmt, computed_columns=computed)
    step = -(-len(events) // commits)
    for c in range(commits):
        sink.write_events(events[c * step:(c + 1) * step])
        sink.commit(c + 1)
    sink.close()
    return sink.table


def cov_database_sync(work: str, dev, n: int) -> dict:
    """CdcDatabaseSync over a filesystem catalog on the card: 3 tables of
    one database, `orders` created beforehand with `qty INT` (widened to
    BIGINT) and an unseen `city` column midway; a foreign database's
    table is filtered out."""
    from paimon_tpu_torch.catalog import create_catalog
    from paimon_tpu_torch.cdc import CdcDatabaseSync

    catalog = create_catalog({"warehouse": os.path.join(work, "cdc_wh")},
                             device=dev)
    catalog.create_database("appdb")
    catalog.create_table("appdb.orders", cdc_schema(qty_int=True))
    streams, oracle = [], {}
    for t, name in enumerate(("users", "orders", "items")):
        changes = cdc_changes(31 + t, n, wide_from=n // 2
                              if name == "orders" else None)
        oracle[name] = cdc_oracle(changes, ["id", "name", "amount", "qty"]
                                  + (["city"] if name == "orders" else []))
        streams.append([ev for op, b, a in changes for ev in cdc_render(
            "debezium", op, b, a, {"database": "appdb", "table": name})])
    streams.append([ev for op, b, a in cdc_changes(39, n // 8)
                    for ev in cdc_render("debezium", op, b, a, {
                        "database": "otherdb", "table": "users"})])
    events = [s[i] for i in range(max(map(len, streams)))
              for s in streams if i < len(s)]
    sync = CdcDatabaseSync(catalog, "appdb", format="debezium",
                           primary_keys={"users": ["id"], "items": ["id"]},
                           table_options={"bucket": "2"})
    step = -(-len(events) // 4)
    for c in range(4):
        sync.write_events(events[c * step:(c + 1) * step])
        sync.commit(c + 1)
    tables = sync.tables()
    sync.close()
    if tables != ["items", "orders", "users"] or \
            "otherdb" in catalog.list_databases():
        raise AssertionError(f"database sync: tables {tables}, databases "
                             f"{catalog.list_databases()}")
    for name in tables:
        same_rows(f"database sync {name}",
                  catalog.get_table(f"appdb.{name}"), oracle[name])
    types = {f.name: f.type.root
             for f in catalog.get_table("appdb.orders").schema.fields}
    if types.get("qty") != "BIGINT" or types.get("city") != "VARCHAR":
        raise AssertionError(f"database sync: orders evolved to {types}")
    return {"events": len(events), "tables": len(tables)}


def cov_formats(work: str, dev, n: int) -> dict:
    """Each format's table equals the Debezium table of the same changes
    (and the oracle)."""
    from paimon_tpu_torch.table import FileStoreTable
    changes = cdc_changes(41, n)
    want = cdc_oracle(changes, ["id", "name", "amount", "qty"])
    rows = {}
    for fmt in ("debezium",) + STREAM_FORMATS:
        table = FileStoreTable.create(os.path.join(work, f"cdc_{fmt}"),
                                      cdc_schema(), device=dev)
        events = [ev for op, b, a in changes
                  for ev in cdc_render(fmt, op, b, a)]
        t = sink_events(table, fmt, events)
        same_rows(f"format {fmt}", t, want)
        rows[fmt] = len(events)
    return {"events": rows}


def cov_computed(work: str, dev, n: int) -> dict:
    """`dt=date_format(order_time, yyyy-MM-dd)` as the partition key."""
    import datetime

    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType, VarCharType
    changes = [c for c in cdc_changes(43, n, keys=n, ts0=STREAM_TS0)
               if c[0] == "c"]
    table = FileStoreTable.create(
        os.path.join(work, "cdc_computed"),
        cdc_schema(extra=(("order_time", BigIntType()),
                          ("dt", VarCharType.string_type())),
                   partition="dt"), device=dev)
    events = [ev for op, b, a in changes
              for ev in cdc_render("debezium", op, b, a)]
    t = sink_events(table, "debezium", events,
                    computed=["dt=date_format(order_time, yyyy-MM-dd)"])
    want = cdc_oracle(changes, ["id", "name", "amount", "qty",
                                "order_time"])
    for r in want:
        r["dt"] = datetime.datetime.fromtimestamp(
            r["order_time"] / 1000, tz=datetime.timezone.utc) \
            .strftime("%Y-%m-%d")
    same_rows("computed dt", t, want)
    return {"events": len(events), "partitions": len({r["dt"]
                                                      for r in want})}


def cov_aggregation(work: str, dev, n: int) -> dict:
    """An aggregation table (amount sum, qty max) fed by a StreamDaemon,
    compacted by its compaction loop: the offset-value-code variant on
    the stream path."""
    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.metrics import STREAM_COMPACTIONS, global_registry
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable

    keys = 4096
    rng = np.random.default_rng(47)
    ids = rng.integers(0, keys, n)
    amount = np.round(rng.random(n) * 100.0, 2)
    qty = rng.integers(1, 1 << 20, n)
    events = [{"op": "c", "after": {"id": i, "amount": a, "qty": q}}
              for i, a, q in zip(ids.tolist(), amount.tolist(),
                                 qty.tolist())]
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.types import BigIntType, DoubleType
    table = FileStoreTable.create(
        os.path.join(work, "cdc_agg"),
        Schema.builder().column("id", BigIntType(False))
        .column("amount", DoubleType()).column("qty", BigIntType())
        .primary_key("id").options({
            "bucket": "2", "merge-engine": "aggregation",
            "fields.amount.aggregate-function": "sum",
            "fields.qty.aggregate-function": "max",
            "stream.checkpoint.interval": "100",
            "stream.compaction.interval": "200",
            "stream.ingest.poll-interval": "10",
            "num-sorted-run.compaction-trigger": "3"}).build(),
        device=dev)
    g = global_registry().stream_metrics()
    c0 = g.counter(STREAM_COMPACTIONS).count
    src = MemoryCdcSource()
    d = StreamDaemon(table, src, serve=False).start()
    try:
        for lo in range(0, n, n // 8):
            src.append(*events[lo:lo + n // 8])
            t0 = time.monotonic()
            while d.status()["offset_committed"] < lo + n // 8 - 1:
                if time.monotonic() - t0 > 60:
                    raise AssertionError(f"aggregation: {d.status()}")
                time.sleep(0.005)
        t0 = time.monotonic()
        while g.counter(STREAM_COMPACTIONS).count == c0:
            if time.monotonic() - t0 > 30:
                raise AssertionError("aggregation: no compaction")
            time.sleep(0.01)
    finally:
        status = d.stop()
    if any(lp["failed"] for lp in status["loops"].values()):
        raise AssertionError(f"aggregation: {status}")
    got = FileStoreTable.load(table.path, device=dev).to_arrow()
    gid = got.column("id").to_numpy()
    order = np.argsort(gid)
    sums = np.zeros(keys)
    np.add.at(sums, ids, amount)
    maxs = np.zeros(keys, dtype=np.int64)
    np.maximum.at(maxs, ids, qty)
    live = np.unique(ids)
    if not np.array_equal(gid[order], live) or \
            not np.allclose(got.column("amount").to_numpy()[order],
                            sums[live], rtol=1e-12, atol=0.0) or \
            not np.array_equal(got.column("qty").to_numpy()[order],
                               maxs[live]):
        raise AssertionError("aggregation: rows differ from numpy")
    return {"events": n, "compactions": g.counter(STREAM_COMPACTIONS).count
            - c0}


class StormFileIO:
    """tests/failing_fileio.py's FailingFileIO for this script (which
    imports nothing of the JAX package): once armed, every mutating op
    past `fail_after` raises, `fail_times` of them (None: until
    disarmed), two-phase closes and commits included."""

    def __init__(self, inner):
        self.inner = inner
        self._left = None           # ops that still succeed; None: off
        self._times = None
        self.failed = 0
        self._lock = threading.Lock()

    def arm(self, fail_after: int, fail_times=None) -> None:
        with self._lock:
            self._left, self._times = fail_after, fail_times

    def disarm(self) -> None:
        with self._lock:
            self._left = self._times = None

    def _tick(self, op: str, path: str) -> None:
        from paimon_tpu_torch.fs.object_store import TransientStoreError
        with self._lock:
            if self._left is None:
                return
            if self._left > 0:
                self._left -= 1
                return
            self.failed += 1
            if self._times is not None:
                self._times -= 1
                if self._times <= 0:
                    self._left = self._times = None
        raise TransientStoreError(f"injected 503 at {op} {path}")

    def write_bytes(self, path, data, overwrite=True):
        self._tick("write_bytes", path)
        return self.inner.write_bytes(path, data, overwrite=overwrite)

    def try_to_write_atomic(self, path, data):
        self._tick("try_to_write_atomic", path)
        return self.inner.try_to_write_atomic(path, data)

    def delete(self, path, recursive=False):
        self._tick("delete", path)
        return self.inner.delete(path, recursive=recursive)

    def delete_quietly(self, path):
        self._tick("delete_quietly", path)
        return self.inner.delete_quietly(path)

    def rename(self, src, dst):
        self._tick("rename", src)
        return self.inner.rename(src, dst)

    def copy(self, src, dst, overwrite=True):
        self._tick("copy", dst)
        return self.inner.copy(src, dst, overwrite=overwrite)

    def new_two_phase_stream(self, path):
        outer, stream = self, self.inner.new_two_phase_stream(path)

        class Stream:
            def write(self, data):
                stream.write(data)

            def close_for_commit(self):
                outer._tick("two_phase.close", path)
                committer = stream.close_for_commit()

                class Committer:
                    def commit(self):
                        outer._tick("two_phase.commit", path)
                        committer.commit()

                    def discard(self):
                        outer._tick("two_phase.discard", path)
                        committer.discard()
                return Committer()

            def __getattr__(self, name):
                return getattr(stream, name)
        return Stream()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def cov_soak(work: str, dev, seconds: float, seed: int = 7,
             kills: int = 3, storms: int = 3) -> dict:
    """The soak harness's short schedule (tests/test_torch_stream_daemon.py
    `run_soak`) on the card: ingest, compaction and serving of a small
    table while 3 transient 503 storms and 3 kill/restart cycles
    mid-checkpoint hit the store; no event lost or duplicated in the
    table or the changelog across incarnations, offsets and identifiers
    rising strictly, fsck clean."""
    import random

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.core.read import ROW_KIND_COL
    from paimon_tpu_torch.service.stream_daemon import (
        PROP_OFFSET, StreamDaemon,
    )
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType

    rng = random.Random(seed)
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", BigIntType()).primary_key("id").options({
                  "bucket": "2", "stream.checkpoint.interval": "80",
                  "stream.compaction.interval": "200",
                  "num-sorted-run.compaction-trigger": "3",
                  "stream.serve.poll-interval": "20",
                  "stream.ingest.poll-interval": "10",
                  "stream.restart.backoff": "20",
                  "stream.restart.backoff.cap": "150",
                  "write.retry.backoff": "5",
                  "snapshot.num-retained.min": "100000",
                  "snapshot.num-retained.max": "100000"}).build())
    base = FileStoreTable.create(os.path.join(work, "cdc_soak"), schema,
                                 device=dev)
    fio = StormFileIO(base.file_io)
    table = FileStoreTable(fio, base.path, base.schema_manager.latest(),
                           device=dev)
    source = MemoryCdcSource()
    expected, materialized = {}, {}
    n = 0

    def drain(daemon, timeout=0.0):
        while True:
            rows = daemon.poll_changelog(timeout=timeout)
            if not rows:
                return
            for r in rows:
                if r[ROW_KIND_COL] in (0, 2):
                    materialized[r["id"]] = r["v"]
                elif r[ROW_KIND_COL] == 3:
                    materialized.pop(r["id"], None)

    t_start = time.monotonic()
    emit_until = t_start + seconds * 0.8
    kill_at = [t_start + seconds * (0.15 + 0.7 * (i + 1) / (kills + 1))
               for i in range(kills)]
    storm_at = [t_start + seconds * (0.1 + 0.7 * (i + 0.5) / (storms + 1))
                for i in range(storms)]
    done_k = done_s = 0
    daemon = StreamDaemon(table, source).start()
    incarnations = 1
    last = 0.0
    try:
        while time.monotonic() < t_start + seconds:
            now = time.monotonic()
            if now < emit_until and now - last >= 0.004:
                evs = []
                for _ in range(4):
                    key = n % 29
                    if expected.get(key) is not None and \
                            rng.random() < 0.08:
                        evs.append({"op": "d", "before": {"id": key,
                                                          "v": n}})
                        expected.pop(key)
                    else:
                        evs.append({"op": "c", "after": {"id": key,
                                                         "v": n}})
                        expected[key] = n
                    n += 1
                source.append(*evs)
                last = now
            drain(daemon)
            if done_s < storms and now >= storm_at[done_s]:
                fio.arm(rng.randrange(0, 4), fail_times=5)
                done_s += 1
            if done_k < kills and now >= kill_at[done_k]:
                fio.arm(0)
                time.sleep(0.05)
                daemon.kill()
                fio.disarm()
                drain(daemon, 0.05)
                daemon = StreamDaemon(table, source).start()
                incarnations += 1
                done_k += 1
            time.sleep(0.002)
        fio.disarm()
        last_offset = source.latest_offset()
        deadline = time.monotonic() + 60
        while daemon.status()["offset_committed"] < last_offset:
            if time.monotonic() > deadline:
                raise AssertionError(f"soak: never converged: "
                                     f"{daemon.status()}")
            drain(daemon)
            time.sleep(0.02)
        status = daemon.stop()
        drain(daemon, 0.05)
    finally:
        fio.disarm()
        daemon.kill()
    final = FileStoreTable.load(base.path, device=dev)
    if status["offset_committed"] != last_offset or \
            {r["id"]: r["v"] for r in final.to_arrow().to_pylist()} \
            != expected or materialized != expected:
        raise AssertionError("soak: lost or duplicated events")
    offs, idents = [], []
    for snap in final.snapshot_manager.snapshots():
        if snap.commit_user == "stream-daemon" and \
                PROP_OFFSET in (snap.properties or {}):
            offs.append(int(snap.properties[PROP_OFFSET]))
            idents.append(snap.commit_identifier)
    if offs != sorted(set(offs)) or offs[-1] != last_offset or \
            idents != sorted(set(idents)):
        raise AssertionError(f"soak: offsets {offs}, identifiers {idents}")
    if not final.fsck().ok:
        raise AssertionError("soak: fsck found violations")
    return {"events": n, "kills": done_k, "storms": done_s,
            "incarnations": incarnations, "ops_failed": fio.failed,
            "checkpoints": len(offs)}


def cov_flight(work: str, dev) -> dict:
    """A loop forced to die for good (max-restarts 0, a broken source)
    leaves a flight dump with its loop.crash event under
    obs.flight.dump.dir."""
    from paimon_tpu_torch.obs import flight
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable

    class Broken:
        def poll(self, after, n):
            raise OSError("source connection lost")

        def backlog(self, after):
            return 0

    dump_dir = os.path.join(work, "flight")
    table = FileStoreTable.create(os.path.join(work, "cdc_flight"),
                                  cdc_schema(), device=dev)
    d = StreamDaemon(table, Broken(), compact=False, serve=False,
                     dynamic_options={"obs.flight.dump.dir": dump_dir,
                                      "stream.restart.max-restarts": "0",
                                      "stream.restart.backoff": "1"})
    try:
        d.start()
        t0 = time.monotonic()
        while not d.status()["loops"]["ingest"]["failed"]:
            if time.monotonic() - t0 > 30:
                raise AssertionError(f"flight: {d.status()}")
            time.sleep(0.01)
        d.stop()
    finally:
        # no dump at this process's exit
        flight.recorder().dump_dir = None
    dumps = sorted(os.listdir(dump_dir))
    with open(os.path.join(dump_dir, dumps[-1])) as f:
        doc = json.load(f)
    crash = [e for e in doc["events"] if e["kind"] == "loop.crash"]
    if len(dumps) != 1 or not crash or crash[-1]["loop"] != "ingest":
        raise AssertionError(f"flight: dumps {dumps}, events "
                             f"{doc['events'][-3:]}")
    return {"dumps": len(dumps), "events": len(doc["events"])}


class StreamCli:
    """`python -m paimon_tpu_torch table stream` as a process on the card
    (on the CPU in a rehearsal) tailing a JSONL file, with tracing on and
    its spool under `spool`; started early, fed in two halves, stopped
    with SIGTERM."""

    def __init__(self, work: str, dev, n: int, spool: str):
        from paimon_tpu_torch.catalog import create_catalog
        root = os.path.dirname(os.path.abspath(__file__))
        self.wh = os.path.join(work, "cli_wh")
        self.dev = dev
        catalog = create_catalog({"warehouse": self.wh}, device=dev)
        catalog.create_database("appdb")
        catalog.create_table("appdb.cli", cdc_schema())
        changes = cdc_changes(53, n)
        self.want = cdc_oracle(changes, ["id", "name", "amount", "qty"])
        self.lines = [json.dumps(ev) for op, b, a in changes
                      for ev in cdc_render("debezium", op, b, a)]
        self.source = os.path.join(work, "cli_events.jsonl")
        self._append(self.lines[:len(self.lines) // 2])
        device = ["--device", "cpu"] if dev.type == "cpu" else []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paimon_tpu_torch", "--warehouse",
             self.wh, *device, "table", "stream", "appdb.cli",
             "--source", self.source,
             "--option", "stream.checkpoint.interval=200",
             "--option", "stream.ingest.poll-interval=20",
             "--option", "trace.enabled=true",
             "--option", f"trace.export.dir={spool}"],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def _append(self, lines) -> None:
        with open(self.source, "a") as f:
            f.write("\n".join(lines) + "\n")

    def feed_rest(self) -> None:
        self._append(self.lines[len(self.lines) // 2:])

    def finish(self, timeout: float = 120.0) -> dict:
        """Wait for the last offset's checkpoint, SIGTERM, and check the
        drain and the table."""
        import signal

        from paimon_tpu_torch.service.stream_daemon import (
            recover_checkpoint,
        )
        from paimon_tpu_torch.table import FileStoreTable
        path = os.path.join(self.wh, "appdb.db", "cli")
        last = len(self.lines) - 1
        deadline = time.perf_counter() + timeout
        while recover_checkpoint(FileStoreTable.load(path, device=self.dev),
                                 "stream-daemon")[0] < last:
            if self.proc.poll() is not None or \
                    time.perf_counter() > deadline:
                self.stop()
                raise AssertionError(f"`table stream` exited "
                                     f"{self.proc.returncode} or stalled: "
                                     f"{self.proc.stderr.read()[-800:]}")
            time.sleep(0.05)
        caught_up = time.perf_counter() - self.t0
        self.proc.send_signal(signal.SIGTERM)
        try:
            out, err = self.proc.communicate(timeout=60)
        finally:
            self.stop()
        status = json.loads(out)
        if self.proc.returncode != 0 or \
                status["offset_committed"] != last or \
                any(lp["failed"] for lp in status["loops"].values()):
            raise AssertionError(f"`table stream` did not drain: exit "
                                 f"{self.proc.returncode}, {status}, "
                                 f"{err[-800:]}")
        same_rows("`table stream`", FileStoreTable.load(
            path, device=self.dev), self.want)
        return {"events": len(self.lines), "caught_up_s": caught_up,
                "s": time.perf_counter() - self.t0}

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def stream_coverage(work: str, rec: Recorder, dev, scale: int,
                    spool: str) -> dict:
    """The coverage checks of the streaming slice but the CLI's; each is
    a check, not a metric (their seconds are logged)."""
    import paimon_tpu_torch.obs.trace as T

    out = {}

    def part(name, fn):
        rec.capture.where = f"stream_coverage {name}"
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["s"] = time.perf_counter() - t0
        log(f"  stream_coverage {name}: {out[name]}")

    part("database_sync", lambda: cov_database_sync(
        work, dev, STREAM_DB_EVENTS // scale))
    # this process's spans for the merged trace
    T.enable_tracing()
    T.set_export_dir(spool)
    try:
        part("formats", lambda: cov_formats(
            work, dev, STREAM_FORMAT_EVENTS // scale))
        T.spool_flush()
    finally:
        T.set_export_dir(None)
        T.disable_tracing()
        T.collector().clear()
    part("computed", lambda: cov_computed(
        work, dev, STREAM_FORMAT_EVENTS // scale))
    part("aggregation", lambda: cov_aggregation(
        work, dev, STREAM_AGG_EVENTS // scale))
    # 5 s until the serving fleet came; the 3 kills and 3 storms stay
    part("soak", lambda: cov_soak(work, dev, 2.5))
    part("flight", lambda: cov_flight(work, dev))
    return out


def merged_trace(work: str, spool: str) -> dict:
    """`fleet trace --merge` over the spools of the `table stream`
    process and of this one: a trace of at least 2 processes."""
    import contextlib
    import io

    from paimon_tpu_torch.cli import main as cli_main
    merged = os.path.join(work, "fleet-trace.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["fleet", "trace", "--merge", spool, "--out", merged])
    stats = json.loads(buf.getvalue())
    if rc != 0 or stats["processes"] < 2:
        raise AssertionError(f"fleet trace --merge: exit {rc}, {stats}")
    return {k: stats[k] for k in ("processes", "spans", "flows")}


def stream_cdc(work: str, rec: Recorder, device="cuda",
               scale: int = 1) -> dict:
    """CDC ingest and the streaming daemon on the card (`scale` divides
    the event counts, for a rehearsal): the `table stream` process and
    stream_orders_2M's events start in processes of their own, then
    stream_coverage runs, then stream_orders_2M, then the process is
    stopped and the trace spools merged; all on a metric registry of
    their own (the soak's injected faults retry; the run's retry check
    counts the other phases).  Returns what the phase reports."""
    import torch

    import paimon_tpu_torch.metrics as M

    dev = torch.device(device)
    t_phase = time.perf_counter()
    saved = M._GLOBAL
    M._GLOBAL = M.MetricRegistry()
    spool = os.path.join(work, "spool")
    gen = OrderEvents(work, STREAM_EVENTS // scale,
                      STREAM_SNAPSHOT // scale, STREAM_CHUNK // scale)
    cli = None
    try:
        cli = StreamCli(work, dev, STREAM_CLI_EVENTS // scale, spool)
        cli.feed_rest()
        cov = stream_coverage(work, rec, dev, scale, spool)
        # the cell's stream metrics only: a registry of its own
        M._GLOBAL = M.MetricRegistry()
        orders = stream_orders(work, rec, dev, scale, gen)
        rec.capture.where = "stream_coverage cli"
        t0 = time.perf_counter()
        cov["cli"] = cli.finish()
        cov["cli"]["s_finish"] = time.perf_counter() - t0
        log(f"  stream_coverage cli: {cov['cli']}")
        cov["merged_trace"] = merged_trace(work, spool)
        log(f"  stream_coverage merged trace: {cov['merged_trace']}")
    finally:
        gen.stop()
        if cli is not None:
            cli.stop()
        M._GLOBAL = saved
        shutil.rmtree(gen.out, ignore_errors=True)
    name = next(p["table"] for p in rec.phases
                if p["table"].startswith("stream_orders"))
    k2 = sum(v for k, v in rec.capture.calls.items()
             if k[0] == "stream_coverage" and k[1] == "ovc")
    cov["launches_ovc"] = k2
    if device != "cpu" and (orders["launches_plain"] == 0 or k2 == 0):
        raise AssertionError(f"stream_cdc: K1 in {name} "
                             f"{orders['launches_plain']} times, K2 in "
                             f"stream_coverage {k2} times")
    out = {name: orders, "stream_coverage": cov,
           "s": time.perf_counter() - t_phase}
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- search: vector, full-text and hybrid search on the card ------------------

SEARCH_ROWS = 1_000_000          # vec_sift_1M: ann-benchmarks' sift-128-
SEARCH_DIM = 128                 # euclidean (SIFT1M) shape: 1M base vectors
SEARCH_QUERIES = 10_000          # of 128 float32 dims, 10,000 queries, l2,
SEARCH_K = 10                    # recall@10
SEARCH_COMMITS = 4               # 4 commits of 250,000 rows, bucket=2
SEARCH_CLUSTERS = 1_000          # the seeded mixture: 1,000 Gaussian
SEARCH_LATENT = 16               # clusters in one 16-dim subspace (SIFT's
SEARCH_CENTRE_SD = 1.0           # intrinsic dimension is low), centres
SEARCH_SPREAD_SD = 0.5           # N(0, I), each cluster N(0, 0.5^2 I)
SEARCH_NOISE_SD = 0.17           # about its centre there, plus N(0,
                                 # 0.17^2 I) noise in every dimension
SEARCH_METRIC_QUERIES = 1_000    # cosine and dot queries each
SEARCH_SQL_QUERIES = 3           # CALL sys.vector_search
SEARCH_SAMPLE = 500              # queries held against the float64 oracle,
                                 # and the IVF queries
SEARCH_PQ_M = 16                 # PQ subspaces of the IVF-PQ index
SEARCH_REFINE = 100              # ADC candidates reranked exactly
SEARCH_APPEND = 1_000            # rows committed after the builds
# recall@10 floors of the reference's own tests: IVF-PQ with refine
# (tests/test_ivfpq.py:32), IVF-SQ (tests/test_ann_sq_hnsw.py:18), HNSW
# (tests/test_ann_sq_hnsw.py:73), IVF-Flat (tests/test_vector_search.py:58)
RECALL_FLOOR = 0.9
FLAT_RECALL_FLOOR = 0.7
HNSW_ROWS, HNSW_DIM, HNSW_QUERIES = 1 << 10, 32, 50   # 2^11 rows until
#                                                      the lake phase came
FLAT_ROWS, FLAT_DIM, FLAT_QUERIES, FLAT_NPROBE = 1 << 16, 64, 100, 8
DOCS = 1 << 15                   # the BEIR-shaped docs table: 2^15 docs of
DOC_VOCAB = 1 << 15              # 8-64 words of a Zipf vocabulary of 2^15
DOC_WORDS = (8, 64)              # terms, 2 later commits of 2^11 docs
DOC_LATE = 1 << 11               # (2^16 and 2^12 until the lake phase came)
DOC_DIM = 64                     # its emb column, for hybrid search
DOC_QUERIES = (30, 10, 10)       # OR terms, +required terms, phrases
DOC_SQL_QUERIES = 1              # CALL sys.full_text_search (it builds an
                                 # in-memory index of every row a call)
BM25_K1, BM25_B = 1.2, 0.75      # the reference's BM25 constants
FP32_FLOPS = 67e12               # H100 SXM, float32 outside the tensor
                                 # cores (NVIDIA data sheet)
SEARCH_PROGRAMS = ("_topk_scores", "_kmeans", "_assign", "_kmeans_batch",
                   "_pq_encode")


def program_cost(name: str, args) -> tuple:
    """(FLOPs, bytes, shape) a device program of vector/ann.py must do
    and move on these inputs: each input read once, each output written
    once."""
    if name == "_topk_scores":
        q, corpus, _, k, metric = args
        (nq, d), n = q.shape, corpus.shape[0]
        return (2 * nq * n * d, 4 * (nq * d + n * d + n) + 12 * nq * k,
                ("Q", nq, "N", n, "D", d, "k", k, metric))
    if name in ("_kmeans", "_assign"):
        v, c = args[0], args[1]
        (n, d), nc = v.shape, c.shape[0]
        iters = args[2] if name == "_kmeans" else 1
        out = 8 * n if name == "_assign" else 4 * nc * d
        return (iters * 2 * n * nc * d, 4 * (n * d + nc * d) + out,
                ("N", n, "C", nc, "D", d, "iters", iters))
    v, c = args[0], args[1]
    m, n, dsub = v.shape
    ksub = c.shape[1]
    iters = args[2] if name == "_kmeans_batch" else 1
    out = n * m if name == "_pq_encode" else 4 * m * ksub * dsub
    return (iters * 2 * m * n * ksub * dsub,
            4 * (m * n * dsub + m * ksub * dsub) + out,
            ("M", m, "N", n, "ksub", ksub, "dsub", dsub, "iters", iters))


class ProgramTimer:
    """Wraps the device programs of vector/ann.py for the search phase:
    each outermost call is counted and timed between two CUDA events on
    the card (host clock on a CPU rehearsal, which is no device time),
    with the FLOPs and bytes its inputs need; the persisted index's write
    is timed on the host clock.  The functions themselves are left as
    they are."""

    def __init__(self, dev):
        self.dev = dev
        self.stats = {p: {"launches": 0, "ms": 0.0, "host_s": 0.0,
                          "flop": 0, "bytes": 0, "shapes": {}}
                      for p in SEARCH_PROGRAMS}
        self.write_s = 0.0
        self._inside = False

    def snapshot(self) -> dict:
        out = {p: (s["ms"], s["host_s"]) for p, s in self.stats.items()}
        out["write"] = (0.0, self.write_s)
        return out

    def since(self, snap: dict) -> dict:
        now = self.snapshot()
        return {p: {"device_ms": now[p][0] - snap[p][0],
                    "host_s": now[p][1] - snap[p][1]} for p in now}

    def _shim(self, name, fn):
        import torch
        on_card = self.dev.type == "cuda"

        def run(*args, **kw):
            if self._inside:            # a program inside another one
                return fn(*args, **kw)
            self._inside = True
            try:
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if on_card:
                    end.record()
                    torch.cuda.synchronize()
                host_s = time.perf_counter() - t0
            finally:
                self._inside = False
            flop, nbytes, shape = program_cost(name, args)
            ms = start.elapsed_time(end) if on_card else host_s * 1e3
            st = self.stats[name]
            by_shape = st["shapes"].setdefault(
                shape, {"launches": 0, "ms": 0.0, "flop": 0, "bytes": 0})
            for acc in (st, by_shape):
                acc["launches"] += 1
                acc["ms"] += ms
                acc["flop"] += flop
                acc["bytes"] += nbytes
            st["host_s"] += host_s
            return out
        return run

    def __enter__(self):
        from paimon_tpu_torch.vector import ann
        self._saved = {p: getattr(ann, p) for p in SEARCH_PROGRAMS}
        for p, fn in self._saved.items():
            setattr(ann, p, self._shim(p, fn))
        self._write = ann.PersistedVectorIndex._write
        timer = self

        def write(index, *args):
            t0 = time.perf_counter()
            try:
                return timer._write(index, *args)
            finally:
                timer.write_s += time.perf_counter() - t0
        ann.PersistedVectorIndex._write = write
        return self

    def __exit__(self, *exc):
        from paimon_tpu_torch.vector import ann
        for p, fn in self._saved.items():
            setattr(ann, p, fn)
        ann.PersistedVectorIndex._write = self._write

    def report(self) -> dict:
        """Per program, in all and at each shape: launches, device ms,
        bound ms and what bounds it, share; at each _topk_scores shape
        also the time its [Q, N] blocks take to write and read once each
        (float32 scores and int64 ranking keys)."""
        def figures(acc):
            by_ops = acc["flop"] / FP32_FLOPS
            by_bytes = acc["bytes"] / HBM_BYTES_PER_S
            bound = max(by_ops, by_bytes) * 1e3
            return {"launches": acc["launches"], "ms": acc["ms"],
                    "bound_ms": bound,
                    "bound_by": "operations" if by_ops >= by_bytes
                    else "bytes",
                    "share": bound / acc["ms"] if acc["ms"] else None}
        out = {}
        for p, st in self.stats.items():
            if not st["launches"]:
                continue
            out[p] = {**figures(st), "host_s": st["host_s"], "shapes": []}
            for shape, acc in st["shapes"].items():
                row = {"shape": list(shape), **figures(acc)}
                if p == "_topk_scores":
                    row["blocks_ms"] = 24 * shape[1] * shape[3] \
                        * acc["launches"] / HBM_BYTES_PER_S * 1e3
                out[p]["shapes"].append(row)
        return out


class Mixture:
    """A seeded mixture of Gaussian clusters in `dim` dimensions, drawn on
    `dev`: centres in a random SEARCH_LATENT-dimensional subspace, each
    cluster spread within it, noise in every dimension; draw() hands
    back float32 host arrays."""

    def __init__(self, dev, dim: int, clusters: int, seed: int):
        import torch
        self.dev, self.dim, self.clusters = dev, dim, clusters
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.basis = torch.randn((SEARCH_LATENT, dim), generator=self.gen,
                                 device=dev) / dim ** 0.5
        self.centres = SEARCH_CENTRE_SD * torch.randn(
            (clusters, SEARCH_LATENT), generator=self.gen, device=dev)

    def draw(self, n: int) -> np.ndarray:
        import torch
        out = np.empty((n, self.dim), np.float32)
        step = 1 << 18
        for lo in range(0, n, step):
            m = min(step, n - lo)
            c = torch.randint(0, self.clusters, (m,), generator=self.gen,
                              device=self.dev)
            latent = self.centres[c] + SEARCH_SPREAD_SD * torch.randn(
                (m, SEARCH_LATENT), generator=self.gen, device=self.dev)
            x = latent @ self.basis + SEARCH_NOISE_SD * torch.randn(
                (m, self.dim), generator=self.gen, device=self.dev)
            out[lo:lo + m] = x.cpu().numpy()
        return out


class VectorOracle:
    """Exact top-k over a corpus in float64.  The float64 scores of a
    result's own k ids bound the oracle's k-th score from below; every
    row scoring at least that (less a margin for rounding) is a
    candidate, found in blocks on `dev` in float64, and the candidates
    are scored and ranked in float64 numpy (score descending, lower id
    first)."""

    BLOCK = 1 << 17

    def __init__(self, x: np.ndarray, dev):
        import torch
        self.x = x.astype(np.float64)
        self.dev = dev
        self.xd = torch.from_numpy(self.x).to(dev)
        self.sqd = (self.xd * self.xd).sum(dim=1)

    def scores(self, q: np.ndarray, ids: np.ndarray, metric: str):
        """float64 scores of the pairs (q[i], x[ids[i, j]])."""
        q = q.astype(np.float64)
        dots = np.einsum("qd,qkd->qk", q, self.x[ids])
        if metric == "dot":
            return dots
        sq = np.einsum("qkd,qkd->qk", self.x[ids], self.x[ids])
        if metric == "cosine":
            return dots / np.maximum(
                np.linalg.norm(q, axis=1)[:, None] * np.sqrt(sq), 1e-12)
        return -(np.sum(q * q, axis=1)[:, None] + sq - 2 * dots)

    def top(self, q: np.ndarray, metric: str, k: int, got_ids) -> tuple:
        import torch
        floor = self.scores(q, np.asarray(got_ids, np.int64),
                            metric).min(axis=1)
        floor = torch.from_numpy(
            floor - 1e-9 * np.maximum(1.0, np.abs(floor))).to(self.dev)
        qd = torch.from_numpy(q.astype(np.float64)).to(self.dev)
        qn = qd.norm(dim=1, keepdim=True)
        cand_q, cand_i = [], []
        for lo in range(0, len(self.x), self.BLOCK):
            xb = self.xd[lo:lo + self.BLOCK]
            s = qd @ xb.T
            if metric == "cosine":
                s = s / torch.clamp(qn * self.sqd[lo:lo + self.BLOCK]
                                    .sqrt()[None, :], min=1e-12)
            elif metric == "l2":
                s = -((qd * qd).sum(dim=1, keepdim=True)
                      + self.sqd[lo:lo + self.BLOCK][None, :] - 2 * s)
            qi, j = torch.nonzero(s >= floor[:, None], as_tuple=True)
            cand_q.append(qi.cpu().numpy())
            cand_i.append(j.cpu().numpy() + lo)
        cq, ci = np.concatenate(cand_q), np.concatenate(cand_i)
        cs = self.scores(q[cq], ci[:, None], metric)[:, 0]
        order = np.lexsort((ci, -cs, cq))
        cq, ci, cs = cq[order], ci[order], cs[order]
        starts = np.searchsorted(cq, np.arange(len(q) + 1))
        if np.any(np.diff(starts) < k):
            raise AssertionError("oracle: fewer than k candidates")
        ids = np.stack([ci[s:s + k] for s in starts[:-1]])
        return np.stack([cs[s:s + k] for s in starts[:-1]]), ids


def search_tau(scores):
    """The exactness rule's tolerance on float32 scores."""
    return 1e-5 * np.maximum(1.0, np.abs(scores))


def topk_agree(what: str, ref_scores, ref_ids, got_scores, got_ids) -> int:
    """The exactness rule (tests/test_torch_vector.py): scores within
    tau; ids equal position by position except inside a run of
    near-ties (reference scores within tau), where the sets agree, and
    one swap at the last position.  Returns the positions that differ."""
    ref_scores = np.asarray(ref_scores, np.float64)
    err = np.abs(np.asarray(got_scores, np.float64) - ref_scores)
    bad = err > search_tau(ref_scores)
    if bad.any():
        qi, j = np.argwhere(bad)[0]
        raise AssertionError(f"{what}: score {got_scores[qi, j]} against "
                             f"{ref_scores[qi, j]} (query {qi}, rank {j})")
    k = ref_ids.shape[1]
    for qi, (s, want, got) in enumerate(zip(ref_scores, ref_ids, got_ids)):
        start = 0
        for j in range(k):
            if j + 1 < k and abs(s[j] - s[j + 1]) <= search_tau(s[j]):
                continue
            run = slice(start, j + 1)
            missing = set(want[run].tolist()) - set(got[run].tolist())
            if len(missing) > (1 if j + 1 == k else 0):
                raise AssertionError(f"{what}: query {qi} ids {got} "
                                     f"against the oracle's {want}")
            start = j + 1
    return int((np.asarray(ref_ids) != np.asarray(got_ids)).sum())


def recall_at(got, exact, k: int) -> float:
    return float(np.mean([len(set(g[:k].tolist()) & set(e[:k].tolist()))
                          for g, e in zip(got, exact)]) / k)


def result_matrix(res, nq: int, k: int) -> tuple:
    """(ids, scores) [nq, k] of a vector_search result of nq queries."""
    ids = res.column("id").to_numpy().reshape(nq, k)
    scores = res.column("_score").to_numpy().reshape(nq, k)
    if "_query" in res.column_names and not np.array_equal(
            res.column("_query").to_numpy(), np.repeat(np.arange(nq), k)):
        raise AssertionError("vector_search: rows out of query order")
    return ids, scores


def write_vectors(table, ids, x: np.ndarray, extra=None) -> None:
    import pyarrow as pa
    cols = {"id": pa.array(ids, pa.int64())}
    cols.update(extra or {})
    cols["emb"] = pa.FixedSizeListArray.from_arrays(
        pa.array(x.ravel()), x.shape[1])
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write_arrow(pa.table(cols))
    wb.new_commit().commit(w.prepare_commit())
    w.close()


def vector_literal(v) -> str:
    """A float32 vector as sys.*_search's comma string (each value's
    shortest repr, which parses back to the same float32)."""
    return ",".join(repr(float(x)) for x in v)


def vec_sift(work: str, rec: Recorder, dev, scale: int,
             timer: ProgramTimer) -> dict:
    """vec_sift_1M through create_catalog, SQLContext and the Python API
    (the phase's docstring says what it drives); returns what it
    reports."""
    import pyarrow as pa
    import torch

    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.sql import SQLContext
    from paimon_tpu_torch.vector import ann

    n = SEARCH_ROWS // scale // SEARCH_COMMITS * SEARCH_COMMITS
    nq = SEARCH_QUERIES // scale
    nm, ns = min(SEARCH_METRIC_QUERIES, nq), min(SEARCH_SAMPLE, nq)
    k = SEARCH_K
    name = "vec_sift_1M" if scale == 1 else f"vec_sift_{n}"
    out: dict = {"rows": n, "queries": nq}
    steps: dict = {}
    programs: dict = {}

    def step(what, rows, fn):
        snap = timer.snapshot()
        t0 = time.perf_counter()
        res = rec.run(name, what, rows, dev, fn)
        steps[what] = time.perf_counter() - t0
        programs[what] = timer.since(snap)
        return res

    t0 = time.perf_counter()
    mix = Mixture(dev, SEARCH_DIM, max(1, SEARCH_CLUSTERS // scale), 7)
    x, q = mix.draw(n), mix.draw(nq)
    out["data_s"] = time.perf_counter() - t0
    catalog = create_catalog({"warehouse": os.path.join(work, "search_wh")},
                             device=dev)
    ctx = SQLContext(catalog)
    ctx.sql("CREATE DATABASE IF NOT EXISTS default")
    step("create table", 0, lambda: ctx.sql(
        "CREATE TABLE vec (id BIGINT NOT NULL, emb VECTOR<FLOAT, 128>, "
        "PRIMARY KEY (id) NOT ENFORCED) WITH ('bucket' = '2')"))
    table = catalog.get_table("default.vec")
    per = n // SEARCH_COMMITS

    def write():
        for c in range(SEARCH_COMMITS):
            lo = c * per
            write_vectors(table, np.arange(lo, lo + per), x[lo:lo + per])
    step(f"write x{SEARCH_COMMITS}", n, write)
    data = step("read", n, table.to_arrow)
    # the read's order is the one vector_search's own read gives its
    # index positions in
    read = ann._as_matrix(data.column("emb"))
    read_ids = data.column("id").to_numpy()
    order = np.argsort(read_ids, kind="stable")
    if not np.array_equal(read_ids[order],
                          np.arange(n)) or not np.array_equal(
            read[order], x):
        raise AssertionError(f"{name} read: rows differ from the written")
    del data

    # brute force: the index on the card; every query through
    # vector_search (l2), which reads the table again, then 1,000 each
    # through the index (cosine, dot)
    got = {}
    for metric, count in (("l2", nq), ("cosine", nm), ("dot", nm)):
        def search(metric=metric, count=count):
            idx = ann.BruteForceIndex(read, metric, device=dev)
            if metric == "l2":
                return result_matrix(ann.vector_search(
                    table, "emb", q[:count], k=k, metric=metric,
                    index=idx), count, k)
            scores, pos = idx.search(q[:count], k)
            return read_ids[pos], scores
        what = (f"vector_search {metric} x{count}" if metric == "l2" else
                f"BruteForceIndex {metric} x{count}")
        got[metric] = step(what, count, search)
        dev_ms = programs[what]["_topk_scores"]["device_ms"]
        out[f"bruteforce_{metric}"] = {
            "queries": count, "s": steps[what],
            "queries_per_s": count / steps[what],
            "device_s": dev_ms / 1e3, "host_s": steps[what] - dev_ms / 1e3}
    t0 = time.perf_counter()
    oracle = VectorOracle(x, dev)
    exact = {}
    for metric in ("l2", "cosine", "dot"):
        ids, scores = got[metric]
        ref_s, ref_i = oracle.top(q[:ns], metric, k, ids[:ns])
        exact[metric] = ref_i
        out[f"bruteforce_{metric}"]["oracle_positions_differ"] = topk_agree(
            f"{name} {metric} against the float64 oracle", ref_s, ref_i,
            scores[:ns], ids[:ns])
    out["oracle_s"] = time.perf_counter() - t0
    log(f"  {name}: brute force l2, cosine, dot equal the float64 oracle "
        f"under the exactness rule on {ns} queries each "
        f"({out['oracle_s']:.2f} s)")

    # the SQL procedure: reads the table and builds its index each call
    for i in range(SEARCH_SQL_QUERIES):
        res = step(f"CALL sys.vector_search {i}", n, lambda i=i: ctx.sql(
            f"CALL sys.vector_search('vec', 'emb', '{vector_literal(q[i])}', "
            f"{k})"))
        ids, scores = result_matrix(res, 1, k)
        topk_agree(f"{name} sys.vector_search {i} against the Python API",
                   got["cosine"][1][i:i + 1], got["cosine"][0][i:i + 1],
                   scores, ids)

    pvi = ann.PersistedVectorIndex(table, "emb")
    for kind in ("ivfpq", "ivfsq"):
        what = f"create_vector_index {kind}"
        line = step(what, n, lambda kind=kind: ctx.sql(
            f"CALL sys.create_vector_index('vec', 'emb', {SEARCH_PQ_M}, "
            f"'l2', '{kind}')")).column(0)[0].as_py()
        idx = pvi.load()
        if idx is None or idx.__class__.__name__ != \
                {"ivfpq": "IVFPQIndex", "ivfsq": "IVFSQIndex"}[kind] or \
                f"{n} vectors, {idx.memory_bytes()} bytes" not in line:
            raise AssertionError(f"{name} {kind}: {line!r}, loaded {idx}")
        p = programs[what]
        parts = {"coarse_kmeans": p["_kmeans"]["host_s"],
                 "assignment": p["_assign"]["host_s"],
                 "codebooks": p["_kmeans_batch"]["host_s"],
                 "encode": p["_pq_encode"]["host_s"],
                 "index_write": p["write"]["host_s"]}
        parts["read_and_host"] = steps[what] - sum(parts.values())
        rep = {"s": steps[what], "parts_s": parts,
               "memory_bytes": idx.memory_bytes(), "result": line}
        searches = [(16, SEARCH_REFINE), (8, 0)] if kind == "ivfpq" \
            else [(16, 0)]
        for nprobe, refine in searches:
            what = f"{kind} nprobe {nprobe} refine {refine} x{ns}"
            # the index's positions are those of the build's read
            res = step(what, ns, lambda: idx.search(
                q[:ns], k, nprobe=nprobe, refine=refine, vectors=read))
            got_ids = np.where(res[1] >= 0, read_ids[res[1]], -1)
            rep[what] = {"queries_per_s": ns / steps[what],
                         "recall_at_10": recall_at(got_ids, exact["l2"], k)}
        out[kind] = rep
        log(f"  {name} {kind}: {rep}")
    for what in ("ivfpq nprobe 16 refine 100", "ivfsq nprobe 16 refine 0"):
        r = out[what[:5]][f"{what} x{ns}"]["recall_at_10"]
        if r < RECALL_FLOOR:
            raise AssertionError(f"{name} {what}: recall@10 {r:.3f} under "
                                 f"the reference's floor {RECALL_FLOOR}")

    # a commit makes the index stale: load() returns None, and
    # load_or_build rebuilds it over every row.  The commit is write-only:
    # the compaction its fifth sorted run would start (8.6 s, both
    # buckets rewritten, in a whole-script run) belongs to the table, not
    # to search
    step(f"commit {SEARCH_APPEND} rows", SEARCH_APPEND, lambda: write_vectors(
        table.copy({"write-only": "true"}), np.arange(n, n + SEARCH_APPEND),
        mix.draw(SEARCH_APPEND)))
    if pvi.load() is not None:
        raise AssertionError(f"{name}: a stale index loaded")
    idx = step("load_or_build ivfpq", n + SEARCH_APPEND,
               lambda: pvi.load_or_build(m=SEARCH_PQ_M, metric="l2"))
    if len(idx) != n + SEARCH_APPEND or pvi.load() is None:
        raise AssertionError(f"{name}: the rebuild holds {len(idx)} rows")
    del read, read_ids
    out["steps_s"] = steps
    mine = [r for r in rec.phases if r["table"] == name]
    out["launches_plain"] = sum(r["launches_plain"] for r in mine)
    peaks = [r["peak_gib"] for r in mine if r["peak_gib"] is not None]
    out["peak_gib"] = max(peaks) if peaks else None
    del x, q, oracle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def docs_corpus(n: int, seed: int = 7) -> tuple:
    """(token ids [n] arrays, texts): n documents of DOC_WORDS words from
    a Zipf vocabulary of DOC_VOCAB terms `t<hex>`."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, DOC_VOCAB + 1)
    lens = rng.integers(DOC_WORDS[0], DOC_WORDS[1] + 1, n)
    flat = np.searchsorted(np.cumsum(p / p.sum()), rng.random(lens.sum()))
    flat = np.minimum(flat, DOC_VOCAB - 1)
    docs = np.split(flat, np.cumsum(lens)[:-1])
    words = np.array([f"t{j:x}" for j in range(DOC_VOCAB)], dtype=object)
    return docs, [" ".join(words[d]) for d in docs], words


class Bm25Oracle:
    """BM25 over the generated token ids in numpy (the reference's K1, B
    and float32 contributions, summed in float64), doc id = row id; OR,
    AND (`+a +b`) and phrase queries; ties by the lower row id."""

    def __init__(self, docs: list, row_ids: np.ndarray):
        self.docs = docs
        self.row_ids = row_ids
        self.dl = np.array([len(d) for d in docs], np.float32)
        self.avgdl = float(sum(len(d) for d in docs)) / len(docs)
        doc = np.repeat(np.arange(len(docs)), [len(d) for d in docs])
        key = np.concatenate(docs).astype(np.int64) * len(docs) + doc
        uniq, tf = np.unique(key, return_counts=True)
        self.term, self.doc, self.tf = uniq // len(docs), \
            uniq % len(docs), tf
        self.bounds = np.searchsorted(self.term, np.arange(DOC_VOCAB + 1))

    def _postings(self, t):
        lo, hi = self.bounds[t], self.bounds[t + 1]
        return self.doc[lo:hi], self.tf[lo:hi].astype(np.float64)

    def search(self, terms: list, mode: str, k: int) -> tuple:
        n = len(self.docs)
        scores = np.zeros(n)
        hits = np.zeros(n, np.int64)
        for t in terms:
            d, tf = self._postings(t)
            idf = math.log(1.0 + (n - len(d) + 0.5) / (len(d) + 0.5))
            denom = tf + BM25_K1 * (1.0 - BM25_B + BM25_B * self.dl[d]
                                    / max(self.avgdl, 1e-9))
            scores[d] += (idf * tf * (BM25_K1 + 1.0) / denom) \
                .astype(np.float32)
            hits[d] += 1
        keep = hits > 0 if mode == "or" else hits == len(terms)
        if mode == "phrase":
            for d in np.flatnonzero(keep):
                toks = self.docs[d]
                starts = np.flatnonzero(toks[:len(toks) - len(terms) + 1]
                                        == terms[0])
                keep[d] = any(all(toks[s + j] == t
                                  for j, t in enumerate(terms))
                              for s in starts)
        d = np.flatnonzero(keep)
        rid = self.row_ids[d]
        order = np.lexsort((rid, -scores[d]))[:k]
        return rid[order], scores[d][order].astype(np.float32)


def doc_queries(docs: list, words, rng) -> list:
    """(query text, term ids, mode): OR queries of 1-3 terms of mid
    frequency, +required pairs from one document, phrases of 2-3
    consecutive words of a document."""
    out = []
    n_or, n_and, n_phrase = DOC_QUERIES
    for _ in range(n_or):
        t = rng.integers(20, 2000, rng.integers(1, 4))
        out.append((" ".join(words[t]), list(t), "or"))
    for _ in range(n_and):
        d = docs[rng.integers(len(docs))]
        t = rng.choice(d, 2, replace=False)
        out.append((" ".join("+" + w for w in words[t]), list(t), "and"))
    for _ in range(n_phrase):
        d = docs[rng.integers(len(docs))]
        w = int(rng.integers(2, 4))
        s = int(rng.integers(0, len(d) - w + 1))
        out.append(('"' + " ".join(words[d[s:s + w]]) + '"',
                    list(d[s:s + w]), "phrase"))
    return out


def same_ranked(what: str, got_ids, got_scores, want_ids, want_scores,
                oracle_score=None) -> None:
    """Equal ranked lists; with `oracle_score` (row id -> score) a list
    whose ties may order otherwise: the same scores in order, each row's
    its oracle score."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_scores = np.asarray(got_scores, np.float32)
    want_scores = np.asarray(want_scores, np.float32)
    if oracle_score is None:
        ok = np.array_equal(got_ids, want_ids) and \
            np.array_equal(got_scores, want_scores)
    else:
        ok = np.array_equal(got_scores, want_scores) and all(
            oracle_score.get(int(i)) == s for i, s in zip(got_ids,
                                                          got_scores))
    if not ok:
        raise AssertionError(f"{what}: {list(zip(got_ids, got_scores))} "
                             f"against {list(zip(want_ids, want_scores))}")


def search_coverage(work: str, rec: Recorder, dev, scale: int) -> dict:
    """HNSW, IVF-Flat, full-text search over a docs table and hybrid
    search on it; each part a check, not a metric (seconds logged)."""
    import pyarrow as pa

    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.index.fulltext import (FullTextIndex,
                                                 PersistedFullTextIndex)
    from paimon_tpu_torch.sql import SQLContext
    from paimon_tpu_torch.vector import ann
    from paimon_tpu_torch.vector.hybrid import RANKERS, rank_hybrid

    out: dict = {}
    k = SEARCH_K
    catalog = create_catalog({"warehouse": os.path.join(work, "search_wh")},
                             device=dev)
    ctx = SQLContext(catalog)
    ctx.sql("CREATE DATABASE IF NOT EXISTS default")

    def part(what, fn):
        rec.capture.where = f"search_coverage {what}"
        t0 = time.perf_counter()
        out[what] = fn()
        out[what]["s"] = time.perf_counter() - t0
        log(f"  search_coverage {what}: {out[what]}")

    def hnsw():
        mix = Mixture(dev, HNSW_DIM, 16, 8)
        v, q = mix.draw(HNSW_ROWS), mix.draw(HNSW_QUERIES)
        ctx.sql(f"CREATE TABLE hnsw (id BIGINT NOT NULL, emb VECTOR<FLOAT, "
                f"{HNSW_DIM}>, PRIMARY KEY (id) NOT ENFORCED) WITH "
                f"('bucket' = '1')")
        table = catalog.get_table("default.hnsw")
        write_vectors(table, np.arange(len(v)), v)
        line = ctx.sql("CALL sys.create_vector_index('hnsw', 'emb', 16, "
                       "'l2', 'hnsw')").column(0)[0].as_py()
        idx = ann.PersistedVectorIndex(table, "emb").load()
        _, ids = idx.search(q, k)
        ref_s, ref_i = VectorOracle(v, dev).top(q, "l2", k, ids)
        r = recall_at(ids, ref_i, k)
        if r < RECALL_FLOOR or type(idx).__name__ != "HNSWIndex":
            raise AssertionError(f"hnsw: recall@10 {r:.3f}, {line}")
        return {"recall_at_10": r, "result": line}

    def ivf_flat():
        mix = Mixture(dev, FLAT_DIM, 64, 9)
        v, q = mix.draw(FLAT_ROWS // scale), mix.draw(FLAT_QUERIES)
        idx = ann.IVFFlatIndex(v, metric="l2", device=dev)
        scores, ids = idx.search(q, k, nprobe=FLAT_NPROBE)
        oracle = VectorOracle(v, dev)
        ref_s, ref_i = oracle.top(q, "l2", k, ids)
        r = recall_at(ids, ref_i, k)
        own = oracle.scores(q, ids, "l2")
        if r < FLAT_RECALL_FLOOR or np.any(
                np.abs(scores - own) > search_tau(own)):
            raise AssertionError(f"ivf_flat: recall@10 {r:.3f}, or a score "
                                 f"off its float64 value")
        return {"recall_at_10": r}

    def fulltext():
        n = DOCS // scale
        late = DOC_LATE // scale
        docs, texts, words = docs_corpus(n)
        emb = Mixture(dev, DOC_DIM, 64, 10).draw(n)
        ctx.sql(f"CREATE TABLE docs (id BIGINT NOT NULL, body STRING, "
                f"emb VECTOR<FLOAT, {DOC_DIM}>) WITH ('bucket' = '-1', "
                f"'row-tracking.enabled' = 'true')")
        table = catalog.get_table("default.docs")
        first = n - 2 * late

        def commit(lo, hi):
            write_vectors(table, np.arange(lo, hi), emb[lo:hi],
                          {"body": pa.array(texts[lo:hi], pa.string())})
        rep: dict = {}
        t0 = time.perf_counter()
        commit(0, first)
        rep["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx = PersistedFullTextIndex.open(table, "body")
        if idx.refresh() != first:
            raise AssertionError("fulltext: the build missed rows")
        rep["build_s"] = time.perf_counter() - t0
        commit(first, first + late)
        commit(first + late, n)
        t0 = time.perf_counter()
        if idx.refresh() != 2 * late or len(idx.meta["segments"]) != 2:
            raise AssertionError("fulltext: refresh missed rows")
        rep["refresh_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.optimize()
        rep["optimize_s"] = time.perf_counter() - t0
        data = table.to_arrow(with_row_ids=True)
        rid = data.column("_ROW_ID").to_numpy()
        ids = data.column("id").to_numpy()
        row_of = np.empty(n, np.int64)
        row_of[ids] = rid
        oracle = Bm25Oracle(docs, row_of)
        t0 = time.perf_counter()
        by_row = np.argsort(rid)
        memory = FullTextIndex([texts[i] for i in ids[by_row]])
        rep["in_memory_build_s"] = time.perf_counter() - t0
        queries = doc_queries(docs, words, np.random.default_rng(7))
        t0 = time.perf_counter()
        for text, terms, mode in queries:
            want = oracle.search(terms, mode, k)
            got = idx.search(text, k)
            same_ranked(f"fulltext persisted {text!r}", *got, *want)
            pos, sc = memory.search(text, k)
            same_ranked(f"fulltext in-memory {text!r}", rid[by_row][pos],
                        sc, *want)
        rep["queries"] = len(queries)
        rep["queries_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for text, terms, mode in queries[:DOC_SQL_QUERIES]:
            res = ctx.sql(f"CALL sys.full_text_search('docs', 'body', "
                          f"'{text}', {k})")
            want = oracle.search(terms, mode, len(docs))
            same_ranked(f"sys.full_text_search {text!r}",
                        row_of[res.column("id").to_numpy()],
                        res.column("_score").to_numpy(), *(
                            a[:k] for a in want),
                        dict(zip(want[0].tolist(), want[1].tolist())))
        rep["sql_queries"] = DOC_SQL_QUERIES
        rep["sql_s"] = time.perf_counter() - t0
        # hybrid: each ranker through SQL against rank_hybrid over the
        # routes' own results
        t0 = time.perf_counter()
        vec = ann.BruteForceIndex(ann._as_matrix(data.column("emb")),
                                  "cosine", device=dev)
        pos_of = {int(r): i for i, r in enumerate(rid)}
        qvs = Mixture(dev, DOC_DIM, 64, 11).draw(len(RANKERS))
        for ranker, qv, (text, _, _) in zip(RANKERS, qvs, queries[3:]):
            res = ctx.sql(f"CALL sys.hybrid_search('docs', 'emb', "
                          f"'{vector_literal(qv)}', 'body', '{text}', {k}, "
                          f"'{ranker}')")
            vs, vi = vec.search(qv, k)
            trid, ts = idx.search(text, k)
            want_pos, fused = rank_hybrid(
                [(vi[0].astype(np.int64), vs[0], 1.0),
                 (np.array([pos_of[int(r)] for r in trid], np.int64), ts,
                  1.0)], ranker=ranker, limit=k)
            same_ranked(f"sys.hybrid_search {ranker}",
                        res.column("id").to_numpy(),
                        res.column("_score").to_numpy(),
                        ids[want_pos], fused)
        rep["hybrid_s"] = time.perf_counter() - t0
        return rep

    part("hnsw", hnsw)
    part("ivf_flat", ivf_flat)
    part("fulltext", fulltext)
    return out


def search(work: str, rec: Recorder, device="cuda", scale: int = 1) -> dict:
    """Search on the card (`scale` divides the row and query counts, for a
    rehearsal): vec_sift_1M, then search_coverage.  Returns what the
    phase reports: the device programs' launches, device ms against
    their bounds, and each path's figures."""
    import torch

    dev = torch.device(device)
    t_phase = time.perf_counter()
    timer = ProgramTimer(dev)
    with timer:
        vec = vec_sift(work, rec, dev, scale, timer)
        t0 = time.perf_counter()
        cov = search_coverage(work, rec, dev, scale)
        cov["s"] = time.perf_counter() - t0
    shutil.rmtree(os.path.join(work, "search_wh"), ignore_errors=True)
    name = next(p["table"] for p in rec.phases
                if p["table"].startswith("vec_sift"))
    if device != "cpu" and vec["launches_plain"] == 0:
        raise AssertionError(f"search: K1 never launched in {name}")
    out = {name: vec, "search_coverage": cov, "programs": timer.report(),
           "s": time.perf_counter() - t_phase}
    for p in ("_topk_scores", "_kmeans", "_assign", "_kmeans_batch",
              "_pq_encode"):
        if p not in out["programs"]:
            raise AssertionError(f"search: {p} never ran")
    if device != "cpu":
        out["card"] = card_line()
    return out


# -- Iceberg export, the loaders, the ingest topology and the VFS ------------

LAKE_CHECKPOINTS = 8             # ice_orders_16M: 8 checkpoints of 2M ids
LAKE_PER_CHECKPOINT = 2_000_000  # uniform in [0, 8M) through 2 writers,
LAKE_KEYS = 8_000_000            # bucket=2: about 224 MB of raw rows a
LAKE_WRITES = 4                  # bucket; each checkpoint in 4 writes
LAKE_WRITERS = 2
LAKE_UPSERT_CHECKPOINTS = 2      # then 2 checkpoints of 500K upserts,
LAKE_UPSERTS = 500_000           # synced before a second full compaction
LAKE_BATCH = 65_536              # jax_batches' rows a batch
LAKE_COLUMNS = ["id", "v1", "v2", "v3"]
LAKE_NS = "lake"
LAKE_DV_ROWS = 1 << 16           # lake_coverage's append table with
LAKE_DV_SHARE = 10               # deletion vectors, 1/10 of it deleted
LAKE_ORC_ROWS = 1 << 15          # the ORC-topped partitioned table: 2
LAKE_LOADER_ROWS = 1 << 18       # commits; the DataLoader's 4-bucket
LAKE_LOADER_WORKERS = 2          # table under 2 spawn workers
LAKE_RR_BATCHES = 9              # round-robin append: 9 batches of 2^12
LAKE_DLF_KEYS = {"lake-ak": "lake-sk"}


class TimedCommitter:
    """An IcebergRestCommitter that records each commit's CAS base and
    its seconds on the host clock."""

    def __init__(self, inner):
        self.inner = inner
        self.bases: list = []
        self.seconds: list = []

    def commit_metadata(self, metadata: dict, base_snapshot_id):
        t0 = time.perf_counter()
        out = self.inner.commit_metadata(metadata, base_snapshot_id)
        self.seconds.append(time.perf_counter() - t0)
        self.bases.append(base_snapshot_id)
        return out


def iceberg_views(table, client, name: str) -> dict:
    """The table's Iceberg views: from its file metadata and from the
    REST catalog's metadata location."""
    from paimon_tpu_torch.iceberg.reader import IcebergTable
    loaded = client.load_table(LAKE_NS, name)
    with open(loaded["metadata-location"]) as f:
        rest = IcebergTable(json.load(f), table.file_io)
    return {"files": IcebergTable.load(table.path), "rest": rest}


def lake_sync(table, committer, name: str, rec: Recorder, dev,
              what: str) -> dict:
    """sync_iceberg through `committer`, timed: the seconds split into
    the metadata write and the REST commit."""
    n = len(committer.seconds)
    t0 = time.perf_counter()
    path = rec.run(name, what, 0, dev, lambda: table.sync_iceberg(
        committer=committer))
    total = time.perf_counter() - t0
    rest = committer.seconds[n] if len(committer.seconds) > n else 0.0
    log(f"  {name} {what}: {total:.3f} s = metadata {total - rest:.3f} s "
        f"+ REST commit {rest:.3f} s -> {os.path.basename(path)}")
    return {"s": total, "metadata_s": total - rest, "rest_s": rest,
            "path": path}


def ice_orders(work: str, rec: Recorder, dev, scale: int, catalog,
               server) -> dict:
    """ice_orders_16M: a primary-key table ingested by a
    StreamIngestTopology of 2 writers (8 checkpoints, the 8th replayed),
    fully compacted on the card, exported to Iceberg through a REST
    catalog and read back by IcebergTable from both metadata locations;
    then 2 checkpoints of upserts and a sync without compaction (the
    view unchanged, the CAS base the first export's snapshot), a second
    compaction and sync; one epoch of jax_batches on the card; the VFS
    over the catalog.  Every answer against a numpy oracle."""
    import torch

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.iceberg.rest import (
        IcebergRestClient, IcebergRestCommitter,
    )
    from paimon_tpu_torch.integrations.jax_data import jax_batches
    from paimon_tpu_torch.table.topology import StreamIngestTopology
    from paimon_tpu_torch.types import BigIntType, DoubleType, IntType
    from paimon_tpu_torch.vfs import Vfs

    name = f"ice_orders_{16 // scale}M" if scale <= 16 else "ice_orders"
    per, keys = LAKE_PER_CHECKPOINT // scale, LAKE_KEYS // scale
    upserts = LAKE_UPSERTS // scale
    rng = np.random.default_rng(7)
    out: dict = {"rows": LAKE_CHECKPOINTS * per}
    steps: dict = {}

    def step(what, rows, fn):
        t0 = time.perf_counter()
        res = rec.run(name, what, rows, dev, fn)
        steps[what] = time.perf_counter() - t0
        return res

    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v1", BigIntType()).column("v2", DoubleType())
              .column("v3", IntType()).primary_key("id")
              .options({"bucket": "2", "write-only": "true"}).build())
    table = catalog.create_table(f"{LAKE_NS}.{name}", schema)
    oracle = SqlOracle(keys)
    t0 = time.perf_counter()
    batches = [[sql_batch(rng, per // LAKE_WRITES, keys)
                for _ in range(LAKE_WRITES)]
               for _ in range(LAKE_CHECKPOINTS)]
    log(f"  {name}: {LAKE_CHECKPOINTS} x {LAKE_WRITES} batches of "
        f"{per // LAKE_WRITES} rows made in {time.perf_counter() - t0:.2f} s")
    threads0 = thread_launches(rec.capture, name)
    topo = StreamIngestTopology(table, num_writers=LAKE_WRITERS,
                                commit_user="lake-ingest")
    try:
        def ingest(ckpts, first):
            for k, ckpt in enumerate(ckpts, first):
                for b in ckpt:
                    topo.write(b)
                if topo.checkpoint(k) is None:
                    raise AssertionError(f"{name}: checkpoint {k} "
                                         f"committed nothing")
        step(f"topology write x{LAKE_CHECKPOINTS}", out["rows"],
             lambda: ingest(batches, 1))
        out["k1_by_thread"] = launches_since(rec.capture, name, threads0)
        latest = table.latest_snapshot().id

        def replay():
            for b in batches[-1]:
                topo.write(b)
            return topo.checkpoint(LAKE_CHECKPOINTS)
        if step("replayed checkpoint", per, replay) is not None or \
                table.latest_snapshot().id != latest:
            raise AssertionError(f"{name}: the replayed checkpoint "
                                 f"{LAKE_CHECKPOINTS} committed")
        t0 = time.perf_counter()
        oracle.upsert(*(np.concatenate(c) for c in zip(
            *(columns_of(b) for ckpt in batches for b in ckpt))))
        del batches
        log(f"  {name}: oracle of the checkpoints in "
            f"{time.perf_counter() - t0:.2f} s")
        live = int(oracle.live.sum())
        out["live"] = live

        if step("full compaction", out["rows"],
                lambda: table.compact(full=True)) is None:
            raise AssertionError(f"{name}: the full compaction committed "
                                 f"nothing")
        client = IcebergRestClient(server.uri)
        committer = TimedCommitter(IcebergRestCommitter(client, LAKE_NS,
                                                        name))
        syncs = [lake_sync(table, committer, name, rec, dev, "sync")]
        first_snap = table.latest_snapshot().id

        def read_views(what):
            views = iceberg_views(table, client, name)
            got = {}
            for where, view in views.items():
                got[where] = step(f"iceberg read ({where}) {what}", live,
                                  view.to_arrow)
                oracle.check(f"{name} iceberg view ({where}) {what}",
                             got[where])
            return views, got
        views, _ = read_views("after the compaction")
        oracle.check(f"{name} table read",
                     step("table read", live, table.to_arrow))
        files0 = sorted(f.file_path for f in views["files"].plan_files())

        # upserts that only a merge-on-read scan sees until the next
        # full compaction
        ups = [sql_batch(rng, upserts, keys)
               for _ in range(LAKE_UPSERT_CHECKPOINTS)]
        step(f"topology upserts x{LAKE_UPSERT_CHECKPOINTS}",
             upserts * LAKE_UPSERT_CHECKPOINTS,
             lambda: ingest([[b] for b in ups], LAKE_CHECKPOINTS + 1))
        syncs.append(lake_sync(table, committer, name, rec, dev,
                               "sync without compaction"))
        if committer.bases[-1] != first_snap:
            raise AssertionError(f"{name}: the CAS base {committer.bases[-1]}"
                                 f" is not the first export's snapshot "
                                 f"{first_snap}")
        views, _ = read_views("after the upserts, not compacted")
        for where, view in views.items():
            if sorted(f.file_path for f in view.plan_files()) != files0:
                raise AssertionError(f"{name}: the un-compacted sync "
                                     f"changed the {where} view's files")
        for b in ups:
            oracle.upsert(*columns_of(b))
        merged_in = live + upserts * LAKE_UPSERT_CHECKPOINTS
        live = int(oracle.live.sum())
        if step("full compaction 2", merged_in,
                lambda: table.compact(full=True)) is None:
            raise AssertionError(f"{name}: the second full compaction "
                                 f"committed nothing")
        syncs.append(lake_sync(table, committer, name, rec, dev, "sync 2"))
        if committer.bases[-1] != table.latest_snapshot().id - 1:
            raise AssertionError(f"{name}: the second CAS base is "
                                 f"{committer.bases[-1]}")
        views, _ = read_views("after the second compaction")
        oracle.check(f"{name} table read 2",
                     step("table read 2", live, table.to_arrow))
    finally:
        topo.close()

    # one epoch of device batches
    on_card = dev.type == "cuda"
    sums = {c: torch.zeros((), dtype=torch.float64 if c == "v2"
                           else torch.int64, device=dev)
            for c in LAKE_COLUMNS}
    count = torch.zeros((), dtype=torch.int64, device=dev)
    moved = batches_seen = 0
    waited = 0.0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = jax_batches(table, LAKE_BATCH, projection=LAKE_COLUMNS,
                     drop_remainder=False)
    while True:
        t1 = time.perf_counter()
        batch = next(it, None)
        waited += time.perf_counter() - t1
        if batch is None:
            break
        batches_seen += 1
        mask = batch.pop("_mask", None)
        for c, x in batch.items():
            if x.device.type != dev.type or x.shape != (LAKE_BATCH,):
                raise AssertionError(f"{name} jax_batches: {c} {x.shape} "
                                     f"on {x.device}")
            moved += x.numel() * x.element_size()
            sums[c] += (x if mask is None else x[mask]).sum(
                dtype=sums[c].dtype)
        count += LAKE_BATCH if mask is None else mask.sum()
        if mask is not None:
            moved += mask.numel()
    if on_card:
        torch.cuda.synchronize()
    epoch = time.perf_counter() - t0
    ids = oracle.ids()
    want = {"id": int(ids.sum()), "v1": int(oracle.v1[ids].sum()),
            "v3": int(oracle.v3[ids].astype(np.int64).sum())}
    got = {c: sums[c].item() for c in LAKE_COLUMNS}
    if int(count.item()) != len(ids) or \
            any(got[c] != want[c] for c in want) or \
            not math.isclose(got["v2"], float(oracle.v2[ids].sum()),
                             rel_tol=1e-12):
        raise AssertionError(f"{name} jax_batches: rows {count.item()}, "
                             f"sums {got} against the oracle's {len(ids)}, "
                             f"{want}")
    rec.add(name, "jax_batches epoch", len(ids), dev, epoch, (0, 0))
    out["loader"] = {
        "batches": batches_seen, "rows_per_s": len(ids) / epoch,
        "epoch_s": epoch, "h2d_bytes": moved,
        "h2d_gb_per_s_epoch": moved / epoch / 1e9,
        "consumer_wait_share": waited / epoch}
    if on_card:
        # the copy engine's rate at the loader's batch: one batch's
        # columns from pinned buffers, 20 times, by CUDA events
        host = torch.empty(moved // batches_seen, dtype=torch.uint8,
                           pin_memory=True)
        dst = torch.empty_like(host, device=dev)
        dst.copy_(host, non_blocking=True)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            dst.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        out["loader"]["h2d_gb_per_s_copy"] = \
            20 * host.numel() / (start.elapsed_time(end) / 1e3) / 1e9
    log(f"  {name} jax_batches: {batches_seen} batches of {LAKE_BATCH} in "
        f"{epoch:.2f} s: {out['loader']}")

    # the VFS over the catalog
    t0 = time.perf_counter()
    vfs = Vfs(catalog)
    listed = {s.path.rsplit("/", 1)[-1]
              for s in vfs.listdir(f"/{LAKE_NS}/{name}")}
    if not {"snapshot", "manifest", "schema", "metadata", "bucket-0",
            "bucket-1"} <= listed:
        raise AssertionError(f"{name} vfs: {sorted(listed)}")
    sid = table.latest_snapshot().id
    with open(os.path.join(table.path, "snapshot", f"snapshot-{sid}"),
              "rb") as f:
        if vfs.open(f"/{LAKE_NS}/{name}/snapshot/snapshot-{sid}") != \
                f.read():
            raise AssertionError(f"{name} vfs: snapshot-{sid} differs from "
                                 f"the file")
    steps["vfs"] = time.perf_counter() - t0
    out.update(syncs=[{k: v for k, v in s.items() if k != "path"}
                      for s in syncs],
               steps_s=steps, cas_bases=committer.bases)
    return out


def lake_coverage(work: str, rec: Recorder, dev, scale: int, catalog,
                  loader) -> dict:
    """lake_coverage: the deletion-vector refusal, an ORC-topped
    partitioned export, a DLF-signed REST round trip, the topology's
    round-robin append and dynamic-bucket refusal, the split tasks, and
    (started by the caller) a DataLoader's spawn workers."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from paimon_tpu_torch import Schema, predicate as P
    from paimon_tpu_torch.catalog.auth import (
        DLFAuthProvider, verify_dlf_request,
    )
    from paimon_tpu_torch.iceberg.reader import IcebergTable
    from paimon_tpu_torch.iceberg.rest import (
        IcebergRESTCatalogServer, IcebergRestClient, IcebergRestCommitter,
    )
    from paimon_tpu_torch.integrations.ray_data import split_read_tasks
    from paimon_tpu_torch.table.topology import StreamIngestTopology
    from paimon_tpu_torch.types import BigIntType, DoubleType, VarCharType

    out: dict = {}
    t_all = time.perf_counter()

    # the deletion vectors of an append table: the export refuses
    n = LAKE_DV_ROWS // scale
    t0 = time.perf_counter()
    dv = catalog.create_table(f"{LAKE_NS}.dv_append", Schema.builder()
                              .column("id", BigIntType(False))
                              .column("v", DoubleType())
                              .options({"bucket": "-1",
                                        "deletion-vectors.enabled": "true"})
                              .build())
    wb = dv.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({"id": pa.array(np.arange(n), pa.int64()),
                                "v": pa.array(np.arange(n) / 2)}))
        wb.new_commit().commit(w.prepare_commit())
    dv.delete_where(P.less_than("id", n // LAKE_DV_SHARE))
    reads = dv.to_arrow().num_rows
    files = [f.file_name for s in dv.new_scan().plan().splits
             for f in s.data_files]
    whole = sum(pq.ParquetFile(os.path.join(dv.path, "bucket-0", f))
                .metadata.num_rows for f in files)
    try:
        dv.sync_iceberg()
        raise AssertionError("dv_append: sync_iceberg exported a table "
                             "whose files carry deletion vectors")
    except ValueError as e:
        if dv.path not in str(e) or not any(f in str(e) for f in files):
            raise AssertionError(f"dv_append: the refusal names neither "
                                 f"the table nor the file: {e}")
    if os.path.exists(os.path.join(dv.path, "metadata")) or \
            reads != n - n // LAKE_DV_SHARE or whole != n:
        raise AssertionError(f"dv_append: {reads} rows read, {whole} in "
                             f"the files")
    dv.compact(full=True)
    dv.sync_iceberg()
    if IcebergTable.load(dv.path).to_arrow().num_rows != reads:
        raise AssertionError("dv_append: the export after compaction")
    out["dv_append"] = {"rows": n, "table_reads": reads,
                        "files_hold": whole,
                        "s": time.perf_counter() - t0}

    # ORC at the top level, a dt partition, a DLF-signed REST catalog
    t0 = time.perf_counter()
    m = LAKE_ORC_ROWS // scale
    orc = catalog.create_table(f"{LAKE_NS}.orc_dt", Schema.builder()
                               .column("id", BigIntType(False))
                               .column("dt", VarCharType(nullable=False))
                               .column("v", DoubleType())
                               .partition_keys("dt").primary_key("id", "dt")
                               .options({"bucket": "2", "write-only": "true",
                                         "file.format.per.level": "5:orc"})
                               .build())
    rng = np.random.default_rng(7)
    days = np.array(["2024-06-01", "2024-06-02", "2024-06-03"])
    for _ in range(2):
        wb = orc.new_batch_write_builder()
        with wb.new_write() as w:
            w.write_arrow(pa.table({
                "id": pa.array(rng.integers(0, m, m), pa.int64()),
                "dt": pa.array(days[rng.integers(0, 3, m)]),
                "v": pa.array(rng.random(m))}))
            wb.new_commit().commit(w.prepare_commit())
    orc.compact(full=True)
    signed = IcebergRESTCatalogServer(
        os.path.join(work, "lake_rest_signed"),
        auth_check=lambda h, method, path, body: verify_dlf_request(
            h, method, path, None, body, LAKE_DLF_KEYS,
            region="r-1")).start()
    try:
        client = IcebergRestClient(signed.uri, auth_provider=DLFAuthProvider(
            "lake-ak", "lake-sk", region="r-1"))
        orc.sync_iceberg(committer=IcebergRestCommitter(client, LAKE_NS,
                                                        "orc_dt"))
        views = iceberg_views(orc, client, "orc_dt")
        try:
            IcebergRestClient(signed.uri).load_table(LAKE_NS, "orc_dt")
            raise AssertionError("orc_dt: an unsigned request was served")
        except RuntimeError as e:
            if "401" not in str(e):
                raise
    finally:
        signed.stop()
    want = orc.to_arrow().sort_by([("dt", "ascending"), ("id", "ascending")])
    for where, view in views.items():
        planned = view.plan_files()
        if {f.file_format for f in planned} != {"orc"} or \
                {f.partition["dt"] for f in planned} != set(days):
            raise AssertionError(f"orc_dt {where}: {planned}")
        got = view.to_arrow().sort_by([("dt", "ascending"),
                                       ("id", "ascending")])
        if got.column_names != want.column_names or not all(
                got.column(c).combine_chunks().equals(
                    want.column(c).combine_chunks())
                for c in want.column_names):
            raise AssertionError(f"orc_dt {where}: rows differ from the "
                                 f"table's")
    out["orc_dt"] = {"rows": want.num_rows, "s": time.perf_counter() - t0}

    # the topology's round-robin append, and its refusal
    t0 = time.perf_counter()
    rr = catalog.create_table(f"{LAKE_NS}.rr_append", Schema.builder()
                              .column("id", BigIntType(False))
                              .options({"bucket": "-1"}).build())
    topo = StreamIngestTopology(rr, num_writers=3)
    try:
        for b in range(LAKE_RR_BATCHES):
            topo.write(pa.table({"id": pa.array(
                np.arange(b << 12, (b + 1) << 12), pa.int64())}))
        topo.checkpoint(1)
    finally:
        topo.close()
    ids = np.sort(rr.to_arrow().column("id").to_numpy())
    if not np.array_equal(ids, np.arange(LAKE_RR_BATCHES << 12)):
        raise AssertionError("rr_append: rows differ")
    dyn = catalog.create_table(f"{LAKE_NS}.dyn", Schema.builder()
                               .column("id", BigIntType(False))
                               .primary_key("id").build())
    try:
        StreamIngestTopology(dyn, num_writers=2)
        raise AssertionError("dyn: a dynamic-bucket table took 2 writers")
    except ValueError as e:
        if "dynamic-bucket" not in str(e):
            raise
    out["topology"] = {"rows": len(ids), "s": time.perf_counter() - t0}

    # the split tasks and the DataLoader's workers over one table
    t0 = time.perf_counter()
    table, dl_iter = loader
    total = table.to_arrow().column("id").to_numpy()
    got = []
    tasks = split_read_tasks(table, projection=["id"])
    for task in tasks:
        got.append(task["fn"]().column("id").to_numpy())
    if len(tasks) < 2 or sum(t["num_rows"] for t in tasks) != len(total) or \
            not np.array_equal(np.sort(np.concatenate(got)), np.sort(total)):
        raise AssertionError("split tasks: they do not cover the table once")
    seen = np.concatenate([b["id"].numpy() for b in dl_iter])
    if not np.array_equal(np.sort(seen), np.sort(total)):
        raise AssertionError(f"DataLoader: {len(seen)} rows seen, the table "
                             f"holds {len(total)}")
    out["loader_workers"] = {"rows": len(seen), "tasks": len(tasks),
                             "s": time.perf_counter() - t0}
    out["s"] = time.perf_counter() - t_all
    log(f"  lake_coverage: {out}")
    return out


def lake_loader(catalog, scale: int) -> tuple:
    """lake_coverage's 4-bucket append table of 2^18 rows and an iterator
    of its DataLoader under 2 spawn workers, started now so that the
    workers come up while the rest of the phase runs."""
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.integrations.torch_data import to_torch_dataloader
    from paimon_tpu_torch.types import BigIntType, DoubleType

    n = LAKE_LOADER_ROWS // scale
    table = catalog.create_table(f"{LAKE_NS}.loader", Schema.builder()
                                 .column("id", BigIntType(False))
                                 .column("v", DoubleType())
                                 .options({"bucket": "4", "bucket-key": "id"})
                                 .build())
    rng = np.random.default_rng(7)
    wb = table.new_batch_write_builder()
    with wb.new_write() as w:
        w.write_arrow(pa.table({"id": pa.array(rng.permutation(n),
                                               pa.int64()),
                                "v": pa.array(rng.random(n))}))
        wb.new_commit().commit(w.prepare_commit())
    dl = to_torch_dataloader(table, projection=["id", "v"],
                             batch_size=n // 16,
                             num_workers=LAKE_LOADER_WORKERS,
                             multiprocessing_context="spawn")
    return table, iter(dl)


def lake_interop(work: str, rec: Recorder, device="cuda",
                 scale: int = 1) -> dict:
    """Iceberg export, the data loaders, the ingest topology and the VFS
    on the card (`scale` divides the row counts, for a rehearsal):
    ice_orders_16M, then lake_coverage, every table through
    create_catalog on the card.  Returns what the phase reports."""
    import torch

    from paimon_tpu_torch import create_catalog
    from paimon_tpu_torch.iceberg.rest import IcebergRESTCatalogServer

    dev = torch.device(device)
    t_phase = time.perf_counter()
    first = len(rec.phases)
    wh = os.path.join(work, "lake_wh")
    catalog = create_catalog({"warehouse": wh}, device=dev)
    catalog.create_database(LAKE_NS)
    loader = lake_loader(catalog, scale)
    server = IcebergRESTCatalogServer(os.path.join(work, "lake_rest")).start()
    try:
        ice = ice_orders(work, rec, dev, scale, catalog, server)
    finally:
        server.stop()
    name = next(p["table"] for p in rec.phases
                if p["table"].startswith("ice_orders"))
    if dev.type == "cuda" and not all(
            p["launches_plain"] for p in rec.phases if p["table"] == name and
            (p["phase"].startswith("topology write") or
             p["phase"].startswith("full compaction"))):
        raise AssertionError(f"lake_interop: K1 did not launch in every "
                             f"write and compaction of {name}")
    cov = lake_coverage(work, rec, dev, scale, catalog, loader)
    shutil.rmtree(wh, ignore_errors=True)
    # each recorded step resets the card's peak: the phase's is theirs
    peaks = [p["peak_gib"] for p in rec.phases[first:]
             if p["peak_gib"] is not None]
    out = {name: ice, "lake_coverage": cov,
           "peak_gib": max(peaks) if peaks else None,
           "s": time.perf_counter() - t_phase}
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


MH_ROUNDS = 8                    # mh_orders_16M: 8 rounds; in each, each
MH_PER_ROUND = 1_000_000         # of 2 processes writes 1M rows, ids
MH_KEYS = 8_000_000              # uniform in [0, 8M): 16M rows, bucket=4
MH_BUCKETS = 4
MH_RESCALED = 8                  # rescale_buckets(8) after the compaction
MH_READS_AFTER = (4, 8)          # pinned scans after these rounds
MH_PROCESSES = 2
MH_COV_ROWS = 1 << 18            # mh_coverage: coordinator/spmd vs cas
MH_LOCAL_ROWS = 1 << 20          # process_local_batch's rows a process
MH_SOAK_EVENTS = 1 << 16         # the plane soak: 2^16 events over 2^12
MH_SOAK_KEYS = 1 << 12           # keys, appended 2^12 a tick
MH_SOAK_CHUNK = 1 << 12
MH_SEED = 7
MH_TIMEOUT_S = 300.0             # each wait of the phase
# tests/multihost_soak.py's SOAK_TABLE_OPTIONS: a 200 ms lease interval
# and a 1,500 ms lease timeout
MH_SOAK_OPTIONS = {
    "bucket": "4",
    "stream.checkpoint.interval": "60",
    "stream.compaction.interval": "120",
    "stream.ingest.poll-interval": "10",
    "stream.serve.poll-interval": "15",
    "num-sorted-run.compaction-trigger": "3",
    "multihost.lease.interval": "200",
    "multihost.lease.timeout": "1500",
    "snapshot.num-retained.min": "100000",
    "snapshot.num-retained.max": "100000",
}


def mh_soak_event(n: int, keys: int) -> dict:
    """The n-th event of the soak's global stream, a pure function of n
    (the port's copy of tests/multihost_soak.py's generator): an upsert
    of key n % keys with value n, a crc32-chosen twelfth of them
    deletes."""
    import zlib
    key = n % keys
    if zlib.crc32(f"soak-{n}".encode()) % 12 == 0:
        return {"op": "d", "before": {"id": key, "v": n}}
    return {"op": "c", "after": {"id": key, "v": n}}


def mh_soak_events(n0: int, n1: int, keys: int) -> list:
    return [mh_soak_event(n, keys) for n in range(n0, n1)]


def mh_expected_state(total: int, keys: int) -> dict:
    """{key: value} after events 0 .. total-1."""
    state: dict = {}
    for n in range(total):
        e = mh_soak_event(n, keys)
        if e["op"] == "d":
            state.pop(n % keys, None)
        else:
            state[n % keys] = n
    return state


def mh_batch(pid: int, rnd: int, n: int, keys: int, dev):
    """One process's rows of one round, made on `dev` from a generator
    seeded by (MH_SEED, pid, rnd): (id, v1 in [0, 2^32), v2, v3) tensors.
    The parent makes the same tensors for its oracle."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(MH_SEED * 1_000_003 + pid * 1009 + rnd)
    ids = torch.randint(0, keys, (n,), generator=g, device=dev)
    v1 = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    v2 = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    v3 = torch.randint(0, 100, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    return ids, v1, v2, v3


def mh_table(ids, v1, v2, v3):
    """The Arrow batch of bench.py's columns from tensors."""
    import pyarrow as pa
    return pa.table({"id": pa.array(ids.cpu().numpy(), pa.int64()),
                     "v1": pa.array(v1.cpu().numpy(), pa.int64()),
                     "v2": pa.array(v2.cpu().numpy(), pa.float64()),
                     "v3": pa.array(v3.cpu().numpy(), pa.int32())})


def _mul32(a, c: int):
    """a * c mod 2^32 for int64 tensors a < 2^32 (c split in halves, so
    no product leaves int64)."""
    lo = (a * (c & 0xFFFF)) & 0xFFFFFFFF
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def mh_buckets(ids, num_buckets: int):
    """Paimon's fixed bucket of BIGINT NOT NULL keys on the keys' device:
    murmur3 (seed 42) over the key's 16-byte BinaryRow (8 null-bit bytes,
    then the value), Java's abs(hash % n); core/bucket.KeyHasher's
    function, held equal to it on a sample by the caller."""
    import torch
    h = torch.full_like(ids, 42)
    lo = ids & 0xFFFFFFFF
    hi = (ids >> 32) & 0xFFFFFFFF
    for word in (None, None, lo, hi):
        if word is not None:
            k = _mul32(_rotl32(_mul32(word, 0xCC9E2D51), 15), 0x1B873593)
            h = h ^ k
        h = (_mul32(_rotl32(h, 13), 5) + 0xE6546B64) & 0xFFFFFFFF
    h = h ^ 16
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return torch.fmod(signed, num_buckets).abs()


def _i64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def mh_row_hash(ids, v1, v2, v3):
    """int64 per row of bench.py's columns on their device (a
    multiplicative mix, wrapping), for per-bucket multiset digests."""
    h = ids * _i64(0x9E3779B97F4A7C15)
    for v, k in ((v1, 0xBF58476D1CE4E5B9), (v2.view(ids.dtype)
                                            if v2.is_floating_point()
                                            else v2, 0x94D049BB133111EB),
                 (v3.to(ids.dtype), 0xD6E8FEB86659FD93)):
        h = (h ^ ((h >> 31) & ((1 << 33) - 1))) * _i64(k) + v
    return h


def mh_digests(buckets, h, num_buckets: int) -> dict:
    """{bucket: [rows, sum of hashes, sum of squares]} (wrapping sums)."""
    import torch
    out = {}
    for name, vals in (("n", torch.ones_like(h)), ("s", h), ("q", h * h)):
        acc = torch.zeros(num_buckets, dtype=torch.int64, device=h.device)
        acc.index_add_(0, buckets, vals)
        out[name] = acc.tolist()
    return {b: [out["n"][b], out["s"][b], out["q"][b]]
            for b in range(num_buckets) if out["n"][b]}


class ChildLaunches:
    """A multihost process's K1/K2 launches: the merge's and the diff's
    references to kernels.eq_next_mask wrapped for the process's run,
    launches counted by (variant, lanes, rows, thread), the first launch
    of each shape held exactly against eq_next_mask_plain on its own
    inputs (no extra launch), and the largest shape's inputs kept for
    the timing that follows the run."""

    def __init__(self):
        self.calls: dict = {}
        self.checked: dict = {}
        self.largest = None
        self._lock = threading.Lock()

    def __enter__(self):
        from paimon_tpu_torch.ops import diff, kernels, merge
        self._modules = (merge, diff)
        self._kernel = kernels.eq_next_mask
        self._plain = kernels.eq_next_mask_plain
        merge.eq_next_mask = self._shim
        diff.eq_next_mask = self._shim
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.eq_next_mask = self._kernel

    def _shim(self, lanes, invalid, ovc_off=None, perm=None,
              num_key_lanes=None, seg_len=None):
        out = self._kernel(lanes, invalid, ovc_off, perm, num_key_lanes,
                           seg_len)
        n = lanes.shape[1]
        shape = ("ovc" if ovc_off is not None else "plain",
                 lanes.shape[0], n)
        thread = threading.current_thread().name.rsplit("_", 1)[0]
        with self._lock:
            key = (*shape, thread)
            self.calls[key] = self.calls.get(key, 0) + 1
            first = shape not in self.checked
            if first:
                self.checked[shape] = 0
        if first:
            want = self._plain(lanes, invalid, ovc_off, perm,
                               num_key_lanes, seg_len)
            err = int((out != want).sum())
            if err:
                self.checked[shape] = err
                raise AssertionError(f"K1 != plain at {shape}: {err} rows")
            kept = tuple(None if t is None else t.clone()
                         for t in (lanes, invalid, ovc_off, perm))
            with self._lock:
                if self.largest is None or n > self.largest[0][2]:
                    self.largest = (shape, kept, num_key_lanes, seg_len)
        return out

    def report(self) -> dict:
        """Launches by shape and thread; the largest shape timed between
        CUDA events (kernel and plain version), beside its bound."""
        import torch

        from paimon_tpu_torch.ops import kernels
        by = {}
        for (variant, lanes, n, thread), k in sorted(self.calls.items()):
            by[f"{variant} L{lanes} n{n} {thread}"] = k
        out = {"launches_plain": sum(k for key, k in self.calls.items()
                                     if key[0] == "plain"),
               "launches_ovc": sum(k for key, k in self.calls.items()
                                   if key[0] == "ovc"),
               "by_shape_thread": by,
               "checked_shapes": len(self.checked),
               "max_abs_err": max(self.checked.values(), default=0)}
        if self.largest is not None and self.largest[1][0].is_cuda:
            shape, (lanes, inv, off, perm), nkl, seg = self.largest

            def kernel():
                return kernels.eq_next_mask(lanes, inv, off, perm, nkl, seg)
            ms = event_ms([kernel])[0]
            plain_ms = cuda_ms(lambda: kernels.eq_next_mask_plain(
                lanes, inv, off, perm, nkl, seg), 5)
            nbytes, _ = needed_bytes(lanes, off, perm, seg)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out["timed"] = {"variant": shape[0], "lanes": shape[1],
                            "n": shape[2], "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "share": bound / ms}
            torch.cuda.synchronize()
        return out


def _mh_write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _mh_until(cond, what: str, timeout: float = MH_TIMEOUT_S,
              parent=None) -> None:
    """Wait for `cond()`; raise after `timeout`, or once the process
    whose pid is `parent` is no longer this process's parent."""
    deadline = time.monotonic() + timeout
    while not cond():
        if parent is not None and os.getppid() != parent:
            raise AssertionError(f"{what}: the parent exited")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout:.0f} s")
        time.sleep(0.01)


def _mh_wait(path: str, what: str, timeout: float = MH_TIMEOUT_S,
             parent=None) -> None:
    """Wait for `path` to exist (as _mh_until)."""
    _mh_until(lambda: os.path.exists(path), what, timeout, parent)


def _mh_share(plane, dev, num_buckets: int) -> dict:
    """This process's pinned split share read and digested per bucket on
    `dev`: the snapshot id, the rows, the seconds, the digests."""
    import torch
    t0 = time.perf_counter()
    sid, splits = plane.pinned_scan()
    read = plane.table.new_read_builder().new_read()
    digests, rows = {}, 0
    for s in splits:
        t = read.read_split(s)
        cols = [torch.from_numpy(np.ascontiguousarray(
                    t.column(c).combine_chunks().to_numpy())).to(dev)
                for c in ("id", "v1", "v2", "v3")]
        got = mh_digests(torch.full_like(cols[0], int(s.bucket)),
                         mh_row_hash(*cols), num_buckets)
        digests[int(s.bucket)] = got.get(int(s.bucket), [0, 0, 0])
        rows += t.num_rows
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"sid": sid, "rows": rows, "s": time.perf_counter() - t0,
            "buckets": digests}


def mh_orders(pid: int, root: str, dev, cfg: dict) -> dict:
    """mh_orders_16M in one process of the plane: rounds of process-local
    rows through the write plane ('exchange' routing, 'cas' arbitration),
    pinned scans, the mesh compaction of the owned groups, the rescale,
    fsck."""
    import torch

    from paimon_tpu_torch.metrics import (
        MULTIHOST_BARRIER_WAIT_MS, MULTIHOST_COMMIT_CONFLICTS,
        MULTIHOST_COMMIT_RETRIES, MULTIHOST_FOREIGN_ROWS, global_registry,
    )
    from paimon_tpu_torch.parallel import multihost as MH
    from paimon_tpu_torch.parallel.mesh_engine import compact_table_mesh
    from paimon_tpu_torch.parallel.sharded_merge import BucketMesh
    from paimon_tpu_torch.table import FileStoreTable

    path = os.path.join(root, "mh_orders")
    if pid == 0:
        FileStoreTable.create(path, bigint_schema({
            "bucket": str(MH_BUCKETS), "write-only": "true",
            "parquet.enable.dictionary": "false"}), device=dev)
    MH.barrier("mh_orders created")
    plane = FileStoreTable.load(path, device=dev).new_distributed_write()
    if (plane.routing, plane.arbitration) != ("exchange", "cas"):
        raise AssertionError(f"mh_orders: {plane.routing}, "
                             f"{plane.arbitration}")
    out = {"writes_s": [], "commits_s": [], "reads": {}}
    for r in range(cfg["rounds"]):
        batch = mh_table(*mh_batch(pid, r, cfg["per_round"], cfg["keys"],
                                   dev))
        t0 = time.perf_counter()
        plane.write_arrow(batch)
        t1 = time.perf_counter()
        if plane.commit(commit_identifier=r + 1) is None:
            raise AssertionError(f"mh_orders: round {r + 1} committed "
                                 f"nothing")
        out["writes_s"].append(t1 - t0)
        out["commits_s"].append(time.perf_counter() - t1)
        if r + 1 in MH_READS_AFTER:
            out["reads"][str(r + 1)] = _mh_share(plane, dev, MH_BUCKETS)
    own = {b for b in range(MH_BUCKETS)
           if plane.ownership.owner_of((), b) == pid}
    MH.barrier("mh_orders written")
    t0 = time.perf_counter()
    stats = compact_table_mesh(
        plane.table, mesh=BucketMesh(1, dev),
        group_filter=lambda part, b: plane.ownership.owner_of(part, b)
        == pid, commit_user=plane.commit_user,
        properties=plane.history.to_properties())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    out["compact"] = {"buckets": stats.buckets, "input_rows":
                      stats.input_rows, "output_rows": stats.output_rows,
                      "windows": stats.windows,
                      "snapshot_id": stats.snapshot_id, "owned": sorted(own)}
    if stats.buckets != len(own) or stats.retries or stats.fallbacks:
        raise AssertionError(f"mh_orders: compaction {out['compact']}, "
                             f"retries {stats.retries}, fallbacks "
                             f"{stats.fallbacks}")
    MH.barrier("mh_orders compacted")
    t0 = time.perf_counter()
    plane.rescale_buckets(MH_RESCALED)
    out["rescale_s"] = time.perf_counter() - t0
    out["rescale_written"] = plane.last_rescale_written_buckets
    if plane.table.options.bucket != MH_RESCALED or \
            plane.ownership.version != 2:
        raise AssertionError("mh_orders: the rescale did not hand off")
    out["reads"]["rescaled"] = _mh_share(plane, dev, MH_RESCALED)
    if pid == 0:
        t0 = time.perf_counter()
        report = FileStoreTable.load(path, device=dev).fsck()
        out["fsck_s"] = time.perf_counter() - t0
        if not report.ok:
            raise AssertionError(f"mh_orders: fsck "
                                 f"{[v.to_dict() for v in report.violations]}")
    MH.barrier("mh_orders checked")
    plane.close()
    g = global_registry().multihost_metrics()
    wait = g.histogram(MULTIHOST_BARRIER_WAIT_MS)
    out.update({
        "foreign_rows_routed": g.counter(MULTIHOST_FOREIGN_ROWS).count,
        "commit_conflicts": g.counter(MULTIHOST_COMMIT_CONFLICTS).count,
        "commit_retries": g.counter(MULTIHOST_COMMIT_RETRIES).count,
        "barrier_wait_ms_p50": wait.percentile(50),
        "barrier_wait_ms_max": wait.max, "barriers": wait.total_count})
    return out


def mh_coverage(pid: int, root: str, dev, cfg: dict) -> dict:
    """mh_coverage in one process: a table under 'coordinator'
    arbitration and 'spmd' routing against the same rows under 'cas'
    and 'exchange', process_local_batch's global sum, and which
    collectives gloo runs on the card's tensors."""
    import datetime

    import torch
    import torch.distributed as dist

    from paimon_tpu_torch.parallel import multihost as MH
    from paimon_tpu_torch.table import FileStoreTable

    out = {}
    n = cfg["cov_rows"]
    rng = np.random.default_rng(MH_SEED + 1)   # the same on both
    ids = rng.permutation(4 * n)[:n].astype(np.int64)
    batch = value_table(ids, random_values(rng, n))
    t0 = time.perf_counter()
    for name, opts, rows in (
            ("coordinator", {"multihost.write.routing": "spmd",
                             "multihost.commit.arbitration":
                             "coordinator"}, batch),
            ("cas", {}, batch.filter(pa_mask(n, pid)))):
        path = os.path.join(root, f"mh_cov_{name}")
        if pid == 0:
            FileStoreTable.create(path, bigint_schema(
                {"bucket": str(MH_BUCKETS), **opts}), device=dev)
        MH.barrier(f"mh_cov {name} created")
        plane = FileStoreTable.load(path, device=dev) \
            .new_distributed_write()
        plane.write_arrow(rows)
        plane.commit(commit_identifier=1)
        plane.close()
    if pid == 0:
        tabs = {name: FileStoreTable.load(
            os.path.join(root, f"mh_cov_{name}"), device=dev)
            for name in ("coordinator", "cas")}
        a, b = (tabs[k].to_arrow().sort_by("id")
                for k in ("coordinator", "cas"))
        if a.num_rows != n or not a.equals(b):
            raise AssertionError("mh_coverage: the coordinator table "
                                 "differs from the cas table")
        users = {k: sorted({s.commit_user for s in
                            t.snapshot_manager.snapshots()})
                 for k, t in tabs.items()}
        if users != {"coordinator": ["writer-committer"],
                     "cas": ["writer-p0", "writer-p1"]}:
            raise AssertionError(f"mh_coverage: commit users {users}")
        out["commit_users"] = users
    out["arbitration_s"] = time.perf_counter() - t0
    # one column sharded along the processes, its global sum
    t0 = time.perf_counter()
    local = mh_batch(pid, 99, cfg["local_rows"], cfg["keys"], dev)[1]
    col = MH.process_local_batch(MH.global_mesh(device=dev),
                                 {"v1": local.cpu().numpy()})["v1"]
    got = int(col.sum())
    want = sum(int(mh_batch(p, 99, cfg["local_rows"], cfg["keys"],
                            dev)[1].sum()) for p in range(MH_PROCESSES))
    if got != want or col.shape != (MH_PROCESSES * cfg["local_rows"],):
        raise AssertionError(f"process_local_batch: sum {got}, oracle "
                             f"{want}, shape {col.shape}")
    out["local_batch"] = {"rows": col.shape[0], "sum": got,
                          "s": time.perf_counter() - t0,
                          "shard_device": str(col.local.device)}
    if dev.type == "cuda":
        # which collectives gloo runs on the card's tensors (the planes
        # stage through host memory by hand and need none of them)
        group = dist.new_group(backend="gloo",
                               timeout=datetime.timedelta(seconds=30))
        x = torch.ones(4, device=dev)
        probes = {}
        for op, fn in (
                ("all_reduce", lambda: dist.all_reduce(x.clone(),
                                                       group=group)),
                ("broadcast", lambda: dist.broadcast(x.clone(), src=0,
                                                     group=group)),
                ("all_gather", lambda: dist.all_gather(
                    [torch.empty_like(x) for _ in range(MH_PROCESSES)], x,
                    group=group)),
                ("all_to_all_single", lambda: dist.all_to_all_single(
                    torch.empty_like(x), x.clone(), group=group))):
            try:
                fn()
                torch.cuda.synchronize()
                probes[op] = "ok"
            except Exception as e:          # noqa: BLE001 — the finding
                probes[op] = f"{type(e).__name__}: {str(e)[:200]}"
        out["gloo_cuda"] = probes
    MH.barrier("mh_coverage done")
    return out


def pa_mask(n: int, pid: int):
    """Rows i of an n-row batch with i % MH_PROCESSES == pid."""
    import pyarrow as pa
    return pa.array(np.arange(n) % MH_PROCESSES == pid)


def mh_soak_table(path: str, dev):
    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.types import BigIntType
    schema = (Schema.builder().column("id", BigIntType(False))
              .column("v", BigIntType()).primary_key("id")
              .options(MH_SOAK_OPTIONS).build())
    return FileStoreTable.create(path, schema, device=dev)


def mh_soak_host(pid: int, root: str, dev, cfg: dict, launches) -> dict:
    """The plane soak on one host: a distributed StreamDaemon with
    plane=MaintenancePlane over the shared table and the identical
    stream.  Process 1 SIGKILLs itself at a third of the stream (after
    writing what it reports); process 0 adopts its buckets, readmits the
    restarted host and checks the table, the offsets, fsck and the
    fleet view."""
    import signal

    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.cli import _fleet_view
    from paimon_tpu_torch.metrics import (
        FLEET_REJOINS, MULTIHOST_MAINTENANCE_TAKEOVERS, global_registry,
    )
    from paimon_tpu_torch.parallel import multihost as MH
    from paimon_tpu_torch.parallel.distributed import resume_ownership_map
    from paimon_tpu_torch.parallel.maintenance_plane import (
        MaintenancePlane,
    )
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable

    path = os.path.join(root, "mh_soak")
    n, keys = cfg["soak_events"], MH_SOAK_KEYS
    if pid == 0:
        mh_soak_table(path, dev)
    MH.barrier("mh_soak created")
    # no collective runs from here on: a dead peer cannot join one
    t = FileStoreTable.load(path, device=dev)
    plane = MaintenancePlane(t, base_user="stream-daemon")
    source = MemoryCdcSource()
    daemon = StreamDaemon(t, source, commit_user="stream-daemon",
                          plane=plane).start()
    t0 = time.perf_counter()
    emitted = 0
    chunk = min(MH_SOAK_CHUNK, n)
    try:
        while emitted < n:
            source.append(*mh_soak_events(emitted, emitted + chunk, keys))
            emitted += chunk
            _mh_until(lambda: daemon.poll_changelog(timeout=0.0) == [] and
                      daemon.status()["offset_pending"] >= emitted - 1,
                      f"mh_soak p{pid} ingest to {emitted}")
            if pid == 1 and emitted >= n // 3:
                _mh_until(lambda: daemon.status()["offset_committed"]
                          >= emitted - 1, "mh_soak p1 checkpoint")
                rep = {"killed_at_offset": emitted - 1,
                       "k1": launches.report(), "kill_time": time.time(),
                       "ingest_s": time.perf_counter() - t0}
                _mh_write_json(os.path.join(root, "p1.killed.json"), rep)
                os.kill(os.getpid(), signal.SIGKILL)
        _mh_wait(os.path.join(root, "p1.killed.json"), "mh_soak kill")
        with open(os.path.join(root, "p1.killed.json")) as f:
            kill_time = json.load(f)["kill_time"]
        # the adoption is durable once the store records host 1 dead
        # (the daemon's ledger names it before its commit lands)
        _mh_until(lambda: daemon.poll_changelog(timeout=0.0) == [] and
                  daemon.status()["distributed"]["adopted"] == [1] and
                  1 in getattr(resume_ownership_map(FileStoreTable.load(
                      path, device=dev)), "dead", ()),
                  "mh_soak takeover")
        takeover_s = time.time() - kill_time
        _mh_write_json(os.path.join(root, "adopted-p1.json"),
                       {"time": time.time()})
        _mh_until(lambda: daemon.poll_changelog(timeout=0.0) == [] and
                  daemon.status()["offset_committed"] >= n - 1 and
                  not plane.ownership.dead and os.path.exists(
                      os.path.join(root, "rejoined-p1.json")),
                  "mh_soak readmission and convergence")
        st = daemon.status()
        _mh_write_json(os.path.join(root, "fleet-converged.json"), {})
        # the restarted host drains and stops first: the store is final
        _mh_wait(os.path.join(root, "rejoiner-stopped.json"),
                 "mh_soak rejoiner stop")
    finally:
        daemon.stop(drain=True)
    plane.refresh_ownership()
    view = _fleet_view(FileStoreTable.load(path, device=dev),
                       "stream-daemon", 16)
    want = {"distributed": True, "version": plane.ownership.version,
            "processes": MH_PROCESSES, "buckets": 4,
            "dead": sorted(plane.ownership.dead),
            "generations": [{"version": m.version,
                             "processes": m.num_processes,
                             "buckets": m.num_buckets,
                             "dead": sorted(m.dead)}
                            for m in plane.history.entries]}
    if {k: view[k] for k in want} != want or want["dead"] or any(
            view["hosts"][str(p)]["owned_buckets"] !=
            [b for b in range(4) if plane.ownership.owner_of((), b) == p]
            for p in range(MH_PROCESSES)):
        raise AssertionError(f"fleet status {view} differs from the "
                             f"plane's view {want}")
    g = global_registry()
    out = {"events": n, "s": time.perf_counter() - t0,
           "takeover_s": takeover_s, "status": st["distributed"],
           "takeovers": g.multihost_metrics().counter(
               MULTIHOST_MAINTENANCE_TAKEOVERS).count,
           "rejoins": g.fleet_metrics().counter(FLEET_REJOINS).count,
           "fleet_view_version": view["version"],
           "generations": [[m.version, sorted(m.dead)]
                           for m in plane.history.entries]}
    if out["takeovers"] < 1 or out["rejoins"] < 1:
        raise AssertionError(f"mh_soak: takeovers {out['takeovers']}, "
                             f"rejoins {out['rejoins']}")
    final = FileStoreTable.load(path, device=dev)
    got = dict(zip(*(final.to_arrow().column(c).to_pylist()
                     for c in ("id", "v"))))
    if got != mh_expected_state(n, keys):
        raise AssertionError("mh_soak: the table differs from the "
                             "stream's state")
    offsets = {p: [] for p in range(MH_PROCESSES)}
    for snap in final.snapshot_manager.snapshots():
        for p in offsets:
            if snap.commit_user == f"stream-daemon-p{p}" and \
                    "stream.source.offset" in (snap.properties or {}):
                offsets[p].append(
                    int(snap.properties["stream.source.offset"]))
    for p, offs in offsets.items():
        if not offs or offs != sorted(set(offs)) or offs[-1] != n - 1:
            raise AssertionError(f"mh_soak: offsets of p{p} {offs[-5:]}")
    t1 = time.perf_counter()
    report = final.fsck()
    out["fsck_s"] = time.perf_counter() - t1
    if not report.ok:
        raise AssertionError(f"mh_soak: fsck "
                             f"{[v.to_dict() for v in report.violations]}")
    out["checkpoints"] = {f"p{p}": len(o) for p, o in offsets.items()}
    return out


def mh_child(role: str, pid: str, port: str, root: str,
             device: str) -> None:
    """A process of the multihost_planes phase, started before the phase
    so that its start overlaps earlier work: a host of the gloo group
    ("host", pid 0 or 1), or the restarted host 1 ("rejoiner", no group:
    it rejoins through the table's snapshots alone).  It reaches the
    card, imports the port, joins the group, writes `<root>/<name>.ready`
    and waits for `<root>/go.json`; it reports to `<root>/<name>.json`,
    or its error to `<root>/<name>.err`, and leaves through os._exit."""
    import traceback

    name = f"p{pid}" if role == "host" else "rejoiner"
    parent = os.getppid()
    try:
        import torch
        t0 = time.perf_counter()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        import pyarrow  # noqa: F401

        from paimon_tpu_torch.parallel import multihost as MH
        from paimon_tpu_torch.table import FileStoreTable  # noqa: F401
        import_s = time.perf_counter() - t0 - card_s
        if role == "host":
            MH.initialize(f"127.0.0.1:{port}", MH_PROCESSES, int(pid),
                          timeout_s=MH_TIMEOUT_S)
        start = {"card_s": card_s, "import_s": import_s,
                 "start_s": time.perf_counter() - t0}
        _mh_write_json(os.path.join(root, f"{name}.ready"), start)
        _mh_wait(os.path.join(root, "go.json"), f"{name} go",
                 timeout=3 * MH_TIMEOUT_S, parent=parent)
        with open(os.path.join(root, "go.json")) as f:
            cfg = json.load(f)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with ChildLaunches() as launches:
            if role == "host":
                out = mh_host(int(pid), root, dev, cfg, launches)
            else:
                out = mh_rejoiner(root, dev, cfg, parent)
        out["start"] = start
        out["k1"] = launches.report()
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if dev.type == "cuda" else None)
        _mh_write_json(os.path.join(root, f"{name}.json"), out)
    except BaseException:                   # noqa: BLE001 — reported
        with open(os.path.join(root, f"{name}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def mh_host(pid: int, root: str, dev, cfg: dict, launches) -> dict:
    import torch
    t0 = time.perf_counter()
    out = {"orders": mh_orders(pid, root, dev, cfg)}
    out["orders"]["s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["coverage"] = mh_coverage(pid, root, dev, cfg)
    out["coverage"]["s"] = time.perf_counter() - t1
    out["before_soak"] = {
        "k1": launches.report(),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                     if dev.type == "cuda" else None)}
    # process 1 dies in the soak: its report so far lands first
    _mh_write_json(os.path.join(root, f"p{pid}.before_soak.json"), out)
    out["soak"] = mh_soak_host(pid, root, dev, cfg, launches)
    return out


def mh_rejoiner(root: str, dev, cfg: dict, parent: int) -> dict:
    """Host 1 restarted after its death: it waits until host 0 has
    adopted its buckets, then runs a distributed StreamDaemon whose
    plane starts `rejoining`, is readmitted, replays its offset gap and
    ingests to the end of the stream; it stops once the fleet has
    converged."""
    from paimon_tpu_torch.cdc.source import MemoryCdcSource
    from paimon_tpu_torch.parallel.maintenance_plane import (
        MaintenancePlane,
    )
    from paimon_tpu_torch.service.stream_daemon import StreamDaemon
    from paimon_tpu_torch.table import FileStoreTable

    _mh_wait(os.path.join(root, "adopted-p1.json"), "rejoiner start",
             parent=parent)
    t0 = time.perf_counter()
    n = cfg["soak_events"]
    t = FileStoreTable.load(os.path.join(root, "mh_soak"), device=dev)
    plane = MaintenancePlane(t, base_user="stream-daemon",
                             process_index=1, process_count=MH_PROCESSES)
    if not plane.rejoining:
        raise AssertionError("the restarted host 1 is not rejoining")
    source = MemoryCdcSource()
    source.append(*mh_soak_events(0, n, MH_SOAK_KEYS))
    daemon = StreamDaemon(t, source, commit_user="stream-daemon",
                          plane=plane).start()
    try:
        _mh_until(lambda: daemon.poll_changelog(timeout=0.0) == [] and
                  not daemon.status()["distributed"]["rejoining"],
                  "rejoiner readmission")
        readmit_s = time.perf_counter() - t0
        _mh_until(lambda: daemon.poll_changelog(timeout=0.0) == [] and
                  daemon.status()["offset_committed"] >= n - 1,
                  "rejoiner convergence")
        st = daemon.status()
        _mh_write_json(os.path.join(root, "rejoined-p1.json"), {})
        _mh_wait(os.path.join(root, "fleet-converged.json"),
                 "rejoiner release", parent=parent)
    finally:
        daemon.stop(drain=True)
        _mh_write_json(os.path.join(root, "rejoiner-stopped.json"), {})
    return {"readmit_s": readmit_s, "s": time.perf_counter() - t0,
            "rejoin_replayed": st["distributed"]["rejoin_replayed"],
            "offset_committed": st["offset_committed"],
            "ownership_version": st["distributed"]["ownership_version"]}


class MhChildren:
    """The phase's three processes (hosts 0 and 1 of the gloo group, the
    restarted host 1), started together before the phase runs."""

    NAMES = ("p0", "p1", "rejoiner")

    def __init__(self, work: str, device: str):
        import socket
        here = os.path.dirname(os.path.abspath(__file__))
        self.root = os.path.join(work, "multihost")
        os.makedirs(self.root)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        self.t0 = time.perf_counter()
        self.procs = {}
        for name, role, pid in (("p0", "host", 0), ("p1", "host", 1),
                                ("rejoiner", "rejoiner", 1)):
            err = open(os.path.join(self.root, f"{name}.stderr"), "w")
            self.procs[name] = (subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.mh_child(*sys.argv[1:])", role, str(pid),
                 str(port), self.root, device], cwd=here,
                env=dict(os.environ, PYTHONPATH=here),
                stdout=subprocess.DEVNULL, stderr=err), err)

    def _failed(self, name: str) -> str:
        path = os.path.join(self.root, f"{name}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()[-3000:]
        with open(os.path.join(self.root, f"{name}.stderr")) as f:
            return f.read()[-3000:]

    def wait_file(self, path: str, what: str,
                  timeout: float = MH_TIMEOUT_S) -> dict:
        """The JSON `path` once it exists; fails as soon as a process
        ends otherwise than it should (host 1 by its own SIGKILL, the
        others with 0)."""
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            for other, (proc, _) in self.procs.items():
                rc = proc.poll()
                if rc is not None and rc != (-9 if other == "p1" else 0):
                    raise AssertionError(
                        f"multihost {other} exited {rc} before {what}: "
                        f"{self._failed(other)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"multihost: {what} not within "
                                     f"{timeout:.0f} s")
            time.sleep(0.02)
        with open(path) as f:
            return json.load(f)

    def ready(self) -> dict:
        return {name: self.wait_file(os.path.join(self.root,
                                                  f"{name}.ready"),
                                     f"{name} ready")
                for name in self.NAMES}

    def go(self, cfg: dict) -> None:
        _mh_write_json(os.path.join(self.root, "go.json"), cfg)

    def join(self, timeout: float = MH_TIMEOUT_S) -> dict:
        """Every process's report: host 1 dies by SIGKILL (its report
        before the soak and at the kill), the others exit 0."""
        out = {}
        out["p1"] = self.wait_file(
            os.path.join(self.root, "p1.before_soak.json"), "p1's report",
            timeout)
        out["p1_killed"] = self.wait_file(
            os.path.join(self.root, "p1.killed.json"), "p1's kill", timeout)
        for name in ("p0", "rejoiner"):
            out[name] = self.wait_file(
                os.path.join(self.root, f"{name}.json"), f"{name}'s report",
                timeout)
        deadline = time.monotonic() + 30
        for name, (proc, _) in self.procs.items():
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            want = -9 if name == "p1" else 0
            if proc.returncode != want:
                raise AssertionError(f"multihost {name} exited "
                                     f"{proc.returncode}, expected {want}: "
                                     f"{self._failed(name)}")
        return out

    def stop(self) -> None:
        for proc, err in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()


def mh_oracle(cfg: dict, dev) -> dict:
    """The oracle's per-bucket digests on `dev`: every row of both
    processes regenerated, each id's last writer (later rounds win;
    within a round the owner writes its own rows, then the peer's it
    receives, each in batch order), after rounds 4 and 8 (4 buckets) and
    after the rescale (8)."""
    import torch

    from paimon_tpu_torch.parallel.distributed import owner_of
    owner = torch.tensor([owner_of((), b, MH_PROCESSES)
                          for b in range(MH_BUCKETS)], device=dev)
    parts = []
    for r in range(cfg["rounds"]):
        for p in range(MH_PROCESSES):
            ids, v1, v2, v3 = mh_batch(p, r, cfg["per_round"], cfg["keys"],
                                       dev)
            foreign = (owner[mh_buckets(ids, MH_BUCKETS)] != p).long()
            key = (r << 22) | (foreign << 21) | torch.arange(
                len(ids), device=dev)
            parts.append((r, ids, v1, v2, v3, key))
    out = {}
    for upto in MH_READS_AFTER:
        sel = [q for q in parts if q[0] < upto]
        ids, v1, v2, v3, key = (torch.cat([q[i] for q in sel])
                                for i in range(1, 6))
        best = torch.full((cfg["keys"],), -1, dtype=torch.int64,
                          device=dev)
        best.scatter_reduce_(0, ids, key, reduce="amax")
        win = key == best[ids]
        cols = (ids[win], v1[win], v2[win], v3[win])
        h = mh_row_hash(*cols)
        out[str(upto)] = mh_digests(mh_buckets(cols[0], MH_BUCKETS), h,
                                    MH_BUCKETS)
        if upto == cfg["rounds"]:
            out["rescaled"] = mh_digests(mh_buckets(cols[0], MH_RESCALED),
                                         h, MH_RESCALED)
            out["live"] = int(win.sum())
    return out


def multihost_planes(work: str, rec: Recorder, children: MhChildren,
                     device="cuda", scale: int = 1) -> dict:
    """The multi-host planes on the card, across OS processes that share
    it: mh_orders_16M, then mh_coverage with the plane soak, every answer
    held against an oracle (`children` were started earlier; `scale`
    divides the row counts, for a rehearsal).  Returns what the phase
    reports."""
    import pyarrow as pa
    import torch

    from paimon_tpu_torch.core.bucket import FixedBucketAssigner
    from paimon_tpu_torch.parallel.distributed import owner_of
    from paimon_tpu_torch.types import BigIntType

    dev = torch.device(device)
    cfg = {"rounds": MH_ROUNDS, "per_round": MH_PER_ROUND // scale,
           "keys": MH_KEYS // scale, "cov_rows": MH_COV_ROWS // scale,
           "local_rows": MH_LOCAL_ROWS // scale,
           "soak_events": max(1 << 10, MH_SOAK_EVENTS // scale)}
    name = f"mh_orders_{2 * MH_ROUNDS * cfg['per_round'] // 1_000_000}M" \
        if scale == 1 else f"mh_orders_{2 * MH_ROUNDS * cfg['per_round']}"
    owners = [owner_of((), b, MH_PROCESSES) for b in range(MH_BUCKETS)]
    if owners != [0, 1, 0, 1]:
        raise AssertionError(f"ownership of buckets 0..3: {owners}")
    compute_mode = None
    if dev.type == "cuda":
        # several processes hold a context on the card at once
        compute_mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        log(f"  multihost: the card's compute mode {compute_mode}")
        if compute_mode != "Default":
            raise AssertionError(f"compute mode {compute_mode}: the "
                                 f"phase's processes share the card")
    t_phase = time.perf_counter()
    ready = children.ready()
    waited = time.perf_counter() - t_phase
    started = time.perf_counter() - children.t0
    log(f"  multihost: the 3 processes ready {started:.1f} s after their "
        f"start (waited {waited:.1f} s here): " + ", ".join(f"{k} card {v['card_s']:.1f} s + imports "
                              f"{v['import_s']:.1f} s, ready at "
                              f"{v['start_s']:.1f} s" for k, v in
                              ready.items()))
    t_go = time.perf_counter()
    children.go(cfg)
    # the oracle on the card while the processes work, its bucket
    # function held against the port's on a sample
    sample = torch.randint(0, 1 << 62, (1 << 16,), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(MH_SEED))
    want = FixedBucketAssigner(["id"], [BigIntType(False)], MH_RESCALED) \
        .assign(pa.table({"id": pa.array(sample.cpu().numpy())}))
    if not np.array_equal(mh_buckets(sample, MH_RESCALED).cpu().numpy(),
                          want):
        raise AssertionError("mh_buckets differs from the port's bucket "
                             "function")
    t0 = time.perf_counter()
    oracle = mh_oracle(cfg, dev)
    oracle_s = time.perf_counter() - t0
    got = children.join()
    run_s = time.perf_counter() - t_go
    hosts = {"p0": got["p0"], "p1": got["p1"]}
    orders = {k: v["orders"] for k, v in hosts.items()}
    # the union of the pinned shares is the oracle, at one snapshot id
    for when in (*map(str, MH_READS_AFTER), "rescaled"):
        reads = [orders[k]["reads"][when] for k in hosts]
        if len({r["sid"] for r in reads}) != 1:
            raise AssertionError(f"{name} read {when}: the processes "
                                 f"pinned {[r['sid'] for r in reads]}")
        union: dict = {}
        for r in reads:
            for b, d in r["buckets"].items():
                if b in union:
                    raise AssertionError(f"{name} read {when}: bucket {b} "
                                         f"read twice")
                union[b] = d
        want_d = {str(b): d for b, d in oracle[when].items()}
        if union != want_d:
            raise AssertionError(f"{name} read {when}: the shares differ "
                                 f"from the oracle ({sorted(union)} vs "
                                 f"{sorted(want_d)})")
    written = sorted(b for k in hosts
                     for b in orders[k]["rescale_written"])
    if written != list(range(MH_RESCALED)):
        raise AssertionError(f"{name}: rescale shares {written}")
    soak = got["p0"]["soak"]
    rej = got["rejoiner"]
    k1 = {"p0": got["p0"]["k1"], "p1": got["p1_killed"]["k1"],
          "rejoiner": rej["k1"]}
    launches = (sum(v["launches_plain"] for v in k1.values()),
                sum(v["launches_ovc"] for v in k1.values()))
    if dev.type == "cuda" and not all(
            v["launches_plain"] for v in (k1["p0"], k1["p1"])):
        raise AssertionError(f"multihost: K1 did not launch in both hosts: "
                             f"{k1}")
    rows = 2 * MH_ROUNDS * cfg["per_round"]
    write_s = max(sum(o["writes_s"]) + sum(o["commits_s"])
                  for o in orders.values())
    peaks = {k: v["before_soak"]["peak_gib"] for k, v in hosts.items()}
    peaks["p0"] = got["p0"]["peak_gib"]
    peaks["rejoiner"] = rej["peak_gib"]
    peak = None if dev.type != "cuda" else max(peaks.values())
    k1_orders = (sum(v["before_soak"]["k1"]["launches_plain"]
                     for v in hosts.values()), 0)
    for what, n_rows, secs in (
            (f"plane write x{MH_ROUNDS} (2 processes, exchange, cas)",
             rows, write_s),
            (f"pinned scan after round {MH_READS_AFTER[0]}",
             rows // 2, max(o["reads"][str(MH_READS_AFTER[0])]["s"]
                            for o in orders.values())),
            (f"pinned scan after round {MH_READS_AFTER[1]}", rows,
             max(o["reads"][str(MH_READS_AFTER[1])]["s"]
                 for o in orders.values())),
            ("mesh compaction of the owned groups", rows,
             max(o["compact_s"] for o in orders.values())),
            (f"rescale to {MH_RESCALED} buckets", oracle["live"],
             max(o["rescale_s"] for o in orders.values())),
            ("pinned scan after the rescale", oracle["live"],
             max(o["reads"]["rescaled"]["s"] for o in orders.values()))):
        rec.add(name, what, n_rows, dev, secs,
                k1_orders if what.startswith("plane write") else (0, 0),
                peak_gib=peak)
    out = {name: {
        "rows": rows, "live": oracle["live"], "processes": MH_PROCESSES,
        "owners": owners, "oracle_s": oracle_s,
        "write_rows_per_s": rows / write_s, "write_s": write_s,
        "steps_s": {k: {s: orders[k][s] for s in (
            "writes_s", "commits_s", "compact_s", "rescale_s")}
            for k in orders},
        "reads": {k: {w: {x: r[x] for x in ("sid", "rows", "s")}
                      for w, r in orders[k]["reads"].items()}
                  for k in orders},
        "fsck_s": orders["p0"].get("fsck_s"),
        **{m: {k: orders[k][m] for k in orders} for m in (
            "foreign_rows_routed", "commit_conflicts", "commit_retries",
            "barrier_wait_ms_p50", "barrier_wait_ms_max", "barriers",
            "compact")}},
        "mh_coverage": {
            "coverage": {k: v["coverage"] for k, v in hosts.items()},
            "soak": soak, "rejoiner": {k: rej[k] for k in (
                "readmit_s", "s", "rejoin_replayed", "offset_committed",
                "ownership_version")},
            "kill_to_takeover_s": soak["takeover_s"],
            "restart_to_readmission_s": rej["readmit_s"],
            "p1_killed_at_offset": got["p1_killed"]["killed_at_offset"]},
        "start": {**ready, "overlapped_s": t_phase - children.t0,
                  "waited_s": waited},
        "k1": k1, "k1_launches": {"plain": launches[0],
                                  "ovc": launches[1]},
        "peak_gib": peaks, "run_s": run_s,
        "s": time.perf_counter() - t_phase}
    log(f"  {name}: write {rows / write_s:,.0f} rows/s; "
        f"foreign rows routed {out[name]['foreign_rows_routed']}; commit "
        f"conflicts {out[name]['commit_conflicts']}, retries "
        f"{out[name]['commit_retries']}; barrier wait p50 "
        f"{out[name]['barrier_wait_ms_p50']} ms, max "
        f"{out[name]['barrier_wait_ms_max']} ms; kill -> takeover "
        f"{soak['takeover_s']:.2f} s, restart -> readmission "
        f"{rej['readmit_s']:.2f} s; K1 {launches[0]} (K2 {launches[1]}) "
        f"by process: " + ", ".join(f"{k} {v['launches_plain']}"
                                    for k, v in k1.items())
        + f"; peak device memory {peaks}; oracle on the card "
        f"{oracle_s:.2f} s; checks passed")
    if dev.type == "cuda":
        out["card"] = card_line()
        out["compute_mode"] = compute_mode
    return out


LINT_RULES = ("collectives", "deadline-wait", "distributed-init",
              "fault-taxonomy", "host-materialization", "lock-order",
              "loop-blocking", "metric-drift", "obs-drift", "options-drift",
              "ownership-history", "sleeps", "sockets", "swallow", "threads")
LINT_META = ("bad-suppression", "stale-suppression")
C12_ROWS = 1 << 22               # c12_stream_4M: 8 commits of 2^19 rows,
C12_RUNS = 8                     # ids uniform in [0, 2^21), seed 12,
C12_THRESHOLD = 1 << 20          # streamed above 2^20 rows
C12_SEED = 12
C12_DEADLINE_MS = 200            # the stalled pumps' request deadline
C12_STALL_S = 3.0                # and how long they stall

# one known-bad site for each rule, in a package named paimon_tpu_torch
# (the drift rules run on no other name); file -> source
LINT_BAD_FILES = {
    "quiet.py": """
def quiet(f):
    try:
        f()
    except Exception:
        pass
""",
    "spin.py": """
import threading


def spin(f):
    return threading.Thread(target=f)


def orphan():
    return 1  # lint-ok: swallow nothing is swallowed here
""",
    "nap.py": """
import time


def nap():
    time.sleep(1)  # lint-ok: sleeps
""",
    "net.py": "import socket\n",
    "sync.py": """
import torch.distributed as dist


def sync():
    dist.barrier()


def mesh_step(parts, t, group):
    dist.all_gather(parts, t, group=group)
""",
    "boot.py": """
import torch.distributed as dist


def boot():
    dist.init_process_group("gloo")
""",
    "ops/kernels.py": """
def launch(t):
    return t.cpu()
""",
    "obs/trace.py": """
STAGE_GHOST = "ghost.stage"
""",
    "options.py": """
class ConfigOption:
    def __init__(self, key, typ, default, description=""):
        self.key, self.typ, self.default = key, typ, default
        self.description = description


class CoreOptions:
    BUCKET = ConfigOption("bucket", int, -1, "Bucket count")
    WRITE_ONLY_DEFAULT_TRUE = ConfigOption("write-only", bool, True, "")
""",
    "service/locks.py": """
import threading

ALPHA_LOCK = threading.Lock()
BETA_LOCK = threading.Lock()


def forward():
    with ALPHA_LOCK:
        take_beta()


def take_beta():
    with BETA_LOCK:
        pass


def backward():
    with BETA_LOCK:
        take_alpha()


def take_alpha():
    with ALPHA_LOCK:
        pass
""",
    "parallel/executors.py": """
def spawn_thread(fn, name=None):
    return fn
""",
    "service/async_server.py": """
import threading

from paimon_tpu_torch.parallel.executors import spawn_thread


class Server:
    def __init__(self):
        self._done_lock = threading.Lock()

    def start(self):
        spawn_thread(self._loop, name="srv-loop")

    def _loop(self):
        while True:
            self._drain()

    def _drain(self):
        with self._done_lock:
            return 1
""",
    "work.py": """
def consume(q):
    return q.get()
""",
    "client.py": """
def fetch(store):
    try:
        return store.read()
    except TransientStoreError:
        return None
""",
    "service/daemon.py": """
def resume(props):
    return props.get("multihost.ownership.version")
""",
}
LINT_BAD_DOC = """\
| Key | Type | Default | Description |
|---|---|---|---|
| `bucket` | int | -1 | Bucket count |
| `write-only` | boolean | false | Skip compaction |
"""
# rule -> (file, a text of the flagged line)
LINT_BAD_SITES = {
    "swallow": ("quiet.py", "except Exception:"),
    "threads": ("spin.py", "threading.Thread("),
    "sleeps": ("nap.py", "time.sleep(1)"),
    "sockets": ("net.py", "import socket"),
    "collectives": ("sync.py", "dist.barrier()"),
    "distributed-init": ("boot.py", "init_process_group"),
    "host-materialization": ("ops/kernels.py", ".cpu()"),
    "obs-drift": ("obs/trace.py", "STAGE_GHOST"),
    "options-drift": ("options.py", '"write-only"'),
    "lock-order": ("service/locks.py", "take_beta()"),
    "loop-blocking": ("service/async_server.py", "with self._done_lock"),
    "deadline-wait": ("work.py", "q.get()"),
    "fault-taxonomy": ("client.py", "except TransientStoreError"),
    "ownership-history": ("service/daemon.py", "multihost.ownership"),
    "bad-suppression": ("nap.py", "time.sleep(1)"),
    "stale-suppression": ("spin.py", "return 1"),
}


def lint_bad_package(root: str) -> tuple:
    """Writes the known-bad package under `root` (with a docs/options.md
    beside it) and returns (its directory, {rule: (display path,
    line)}): each of the 15 rules flags exactly one site, metric-drift
    the one of paimon_tpu_torch.metrics' constants that the package's
    producers.py does not name, plus a reasonless and an orphaned
    marker."""
    import paimon_tpu_torch.metrics as M

    pkg = os.path.join(root, "paimon_tpu_torch")
    names = [n for n in M.__all__ if n.isupper()]
    # a constant that no other contains, so naming the rest misses it
    orphan = next(n for n in names
                  if not any(n in m for m in names if m != n))
    files = {**LINT_BAD_FILES, "__init__.py": "",
             "metrics.py": "".join(f'{n} = "{n.lower()}"\n'
                                   for n in names),
             "producers.py": "".join(f"# {n}\n" for n in names
                                     if n != orphan)}
    for rel, src in files.items():
        path = os.path.join(pkg, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src.lstrip("\n"))
    os.makedirs(os.path.join(root, "docs"), exist_ok=True)
    with open(os.path.join(root, "docs", "options.md"), "w") as f:
        f.write(LINT_BAD_DOC)
    want = {"metric-drift": ("paimon_tpu_torch/metrics.py",
                             names.index(orphan) + 1)}
    for rid, (rel, text) in LINT_BAD_SITES.items():
        lines = files[rel].lstrip("\n").splitlines()
        want[rid] = (f"paimon_tpu_torch/{rel}",
                     next(i + 1 for i, line in enumerate(lines)
                          if text in line))
    return pkg, want


def check_known_bad(root: str) -> dict:
    """Every rule against the known-bad package: each reports exactly
    its finding (none suppressed), and `paimon lint` exits 1 on it."""
    import contextlib
    import io

    from paimon_tpu_torch import cli
    from paimon_tpu_torch.analysis import run_package

    t0 = time.perf_counter()
    pkg, want = lint_bad_package(root)
    report = run_package(pkg)
    got = {}
    for f in report.findings:
        if f.rule in got or f.suppressed:
            raise AssertionError(f"known-bad package: a second or "
                                 f"suppressed finding {f}")
        got[f.rule] = (f.file, f.line)
    if got != want:
        raise AssertionError(f"known-bad package: findings {got}, "
                             f"expected {want}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", "--package-dir", pkg])
    last = out.getvalue().splitlines()[-1]
    if rc != 1 or not last.endswith(f"{len(want)} finding(s), 0 "
                                    f"suppressed"):
        raise AssertionError(f"paimon lint on the known-bad package: "
                             f"exit {rc}, {last!r}")
    return {"findings": len(report.findings), "cli_exit": rc,
            "s": time.perf_counter() - t0}


class LintChild:
    """`python -m paimon_tpu_torch lint --json` over the checkout's
    package, started now from the checkout's root; a thread of its own
    waits for it, so its wall time is its own."""

    def __init__(self):
        root = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        self.s = None
        self.out = self.err = ""
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paimon_tpu_torch", "lint", "--json"],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        self.out, self.err = self.proc.communicate()
        self.s = time.perf_counter() - self.t0

    def report(self, timeout: float = 120.0) -> dict:
        self.thread.join(timeout)
        if self.proc.poll() is None:
            self.proc.kill()
            self.thread.join()
            raise AssertionError(f"paimon lint did not end in {timeout} s")
        if self.proc.returncode != 0:
            raise AssertionError(f"paimon lint: exit {self.proc.returncode}"
                                 f": {self.out[-500:]} {self.err[-500:]}")
        return json.loads(self.out)


def c12_compaction(work: str, rec: Recorder, dev, scale: int) -> dict:
    """ROADMAP C.12 on the card: c12_stream_4M, bench.py's columns in 8
    commits, compacted down the streamed path (stream-threshold-rows
    below its rows, so _prefetch, _collect and flush run).  With every
    run's pump stalled for C12_STALL_S inside deadline_scope(200) the
    compaction raises DeadlineExceededError within 1.5 s and commits
    nothing; then, unstalled and with no deadline, it commits rows equal
    to the last-writer oracle, its merges launching K1."""
    import paimon_tpu_torch.compact.manager as manager
    from paimon_tpu_torch.table import FileStoreTable
    from paimon_tpu_torch.utils.deadline import (
        DeadlineExceededError, deadline_scope,
    )

    t_phase = time.perf_counter()
    rows = C12_ROWS // scale
    name = f"c12_stream_{rows >> 20}M" if scale == 1 else \
        f"c12_stream_{rows}"
    batches = bigint_batches(rows, runs=C12_RUNS, seed=C12_SEED)
    cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
            for c in ("id", "v1", "v2", "v3")}
    win = last_writer_oracle(cols["id"])
    path = os.path.join(work, name)
    table = FileStoreTable.create(path, bigint_schema({
        "bucket": "1", "write-only": "true",
        "parquet.enable.dictionary": "false",
        "tpu.merge.stream-threshold-rows": str(C12_THRESHOLD // scale)}),
        device=dev)

    def write():
        for b in batches:
            wb = table.new_batch_write_builder()
            with wb.new_write() as w:
                w.write_arrow(b)
                wb.new_commit().commit(w.prepare_commit())
    rec.run(name, "write", rows, dev, write)
    snapshot = table.snapshot_manager.latest_snapshot_id()
    release = threading.Event()
    prefetch = manager._prefetch

    def stalled_prefetch(it, depth=2):
        def stalled_run():
            release.wait(C12_STALL_S)
            yield from it
        return prefetch(stalled_run(), depth)

    manager._prefetch = stalled_prefetch
    t0 = time.perf_counter()
    try:
        with deadline_scope(C12_DEADLINE_MS):
            table.compact(full=True)
    except DeadlineExceededError as e:
        raised_s, raised = time.perf_counter() - t0, str(e)
    else:
        raise AssertionError(f"{name}: the stalled compaction under "
                             f"deadline_scope({C12_DEADLINE_MS}) did not "
                             f"raise")
    finally:
        manager._prefetch = prefetch
        release.set()
    if raised_s >= 1.5 or "compaction prefetch" not in raised:
        raise AssertionError(f"{name}: the stalled compaction raised "
                             f"{raised!r} after {raised_s:.2f} s")
    if table.snapshot_manager.latest_snapshot_id() != snapshot:
        raise AssertionError(f"{name}: the stalled compaction committed")
    # the released pumps see the cancel flag and end
    t1 = time.perf_counter()
    while any(t.name.startswith("paimon-prefetch-pump")
              for t in threading.enumerate()):
        if time.perf_counter() - t1 > C12_STALL_S + 5:
            raise AssertionError(f"{name}: a prefetch pump outlived its "
                                 f"compaction")
        time.sleep(0.01)
    if rec.run(name, "compact", rows, dev,
               lambda: table.compact(full=True)) is None:
        raise AssertionError(f"{name}: the compaction committed nothing")
    got = rec.run(name, "read", rows, dev, table.to_arrow)
    check_rows(f"{name} read after compaction", got, cols, win, "id")
    compact = next(p for p in reversed(rec.phases)
                   if p["table"] == name and p["phase"] == "compact")
    if dev.type == "cuda" and compact["launches_plain"] == 0:
        raise AssertionError(f"{name}: the streamed compaction launched "
                             f"no K1")
    shutil.rmtree(path, ignore_errors=True)
    return {"table": name, "rows": rows, "runs": C12_RUNS,
            "stream_threshold_rows": C12_THRESHOLD // scale,
            "deadline_ms": C12_DEADLINE_MS, "stall_s": C12_STALL_S,
            "raised_after_s": raised_s, "raised": raised,
            "compact_rows_per_s": compact["rows_per_s"],
            "k1_compact": compact["launches_plain"],
            "live_rows": got.num_rows, "s": time.perf_counter() - t_phase}


def analysis(work: str, rec: Recorder, device="cuda", scale: int = 1) -> dict:
    """The whole-program analysis plane on the card's machine (`scale`
    divides C.12's rows, for a rehearsal): `paimon lint --json` in a
    process of its own over the checked-out package (exit 0, no
    unsuppressed finding, the 15 rules and 2 meta ids), the same run in
    this process, every rule against the known-bad package, and C.12's
    compaction on the card.  Returns what the phase reports."""
    import torch

    import paimon_tpu_torch
    from paimon_tpu_torch.analysis import run_package

    dev = torch.device(device)
    t_phase = time.perf_counter()
    child = LintChild()
    known_bad = check_known_bad(os.path.join(work, "lint_bad"))
    c12 = c12_compaction(work, rec, dev, scale)
    t0 = time.perf_counter()
    mine = run_package(os.path.dirname(paimon_tpu_torch.__file__))
    in_process_s = time.perf_counter() - t0
    report = child.report()
    rules = sorted(LINT_RULES) + list(LINT_META)
    if report["rules"] != rules or report["summary"]["unsuppressed"] or \
            mine.unsuppressed or \
            report["summary"] != mine.to_dict()["summary"]:
        raise AssertionError(f"paimon lint over the checkout: rules "
                             f"{report['rules']}, summary "
                             f"{report['summary']}; in process "
                             f"{mine.to_dict()['summary']}")
    out = {"cli": {"files": report["files"], "rules": len(report["rules"]),
                   "unsuppressed": report["summary"]["unsuppressed"],
                   "suppressed": report["summary"]["suppressed"],
                   "s": child.s},
           "in_process_s": in_process_s, "known_bad": known_bad,
           "c12": c12, "s": time.perf_counter() - t_phase}
    log(f"  analysis: paimon lint over {report['files']} files in "
        f"{child.s:.1f} s (its process), {in_process_s:.1f} s in this one: "
        f"0 findings, {report['summary']['suppressed']} suppressed; the "
        f"known-bad package's {known_bad['findings']} findings exact; "
        f"{c12['table']} stalled under a {C12_DEADLINE_MS} ms deadline "
        f"raised in {c12['raised_after_s']:.2f} s, compacted at "
        f"{c12['compact_rows_per_s']:,.0f} rows/s with {c12['k1_compact']} "
        f"K1 launches; phase {out['s']:.1f} s")
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


BIG_TABLES = ("dedup_bigint", "agg_sum_max_orc", "device_decode_dedup")
APPEND_TABLES = ("ap_log_16M", "ap_sort_coverage", "ap_tracked_1M",
                 "ap_queue_coverage")


def main_path(rows: int, phases: list, capture: LaunchCapture,
              reducer: ReduceTimer, timer: ChangelogTimer,
              c5: dict, decode_timer: DecodeTimer, decoded: dict,
              mesh: dict, served: dict, bucketed: dict,
              maintained: dict, planes: dict, indexed: dict,
              appended: dict, formatted: dict, sqled: dict,
              streamed: dict, searched: dict, fleet: dict,
              laked: dict, multihost: dict, analysed: dict) -> tuple:
    import pyarrow as pa

    from paimon_tpu_torch import Schema
    from paimon_tpu_torch.ops import kernels
    from paimon_tpu_torch.types import BigIntType, VarCharType

    def counts():
        return (kernels.EQ_NEXT_LAUNCHES - kernels.EQ_NEXT_OVC_LAUNCHES,
                kernels.EQ_NEXT_OVC_LAUNCHES)

    totals = [0, 0]
    work = tempfile.mkdtemp(prefix="paimon-chip-smoke-")
    rec = Recorder(counts, phases, capture, reducer)
    # retries and sidecar fallbacks of the whole run: only faults_500K's
    # injected faults may retry
    planes0 = plane_counters()

    def path(name, fn):
        """One path of the main path on the card: the launch counts set
        to 0 just before it and read just after."""
        kernels.EQ_NEXT_LAUNCHES = 0
        kernels.EQ_NEXT_OVC_LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        launched = counts()
        totals[0] += launched[0]
        totals[1] += launched[1]
        log(f"  {name}: launches plain={launched[0]} ovc={launched[1]} "
            f"in {time.perf_counter() - t0:.1f} s")
        return out

    def drive(name, schema, batches, check, **kw):
        def run():
            out = drive_table(os.path.join(work, name), schema, batches,
                              check, rec, **kw)
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
            return out
        return path(name, run)

    oracles = None
    mh_children = None
    try:
        t0 = time.perf_counter()
        batches = bigint_batches(rows)
        log(f"batches of {rows} rows made in {time.perf_counter() - t0:.1f} "
            f"s")
        # started once this process's batches are made: the two do not
        # contend for the cores while they fill their arrays
        oracles = OracleChild(rows, work)
        cols = {c: np.concatenate([b.column(c).to_numpy() for b in batches])
                for c in ("id", "v1", "v2", "v3")}
        base = {"bucket": "1", "write-only": "true",
                "parquet.enable.dictionary": "false"}

        decode_dir = os.path.join(work, "device_decode_dedup")

        def copy_dedup():
            t0 = time.perf_counter()
            shutil.copytree(os.path.join(work, "dedup_bigint"), decode_dir)
            log(f"  dedup_bigint copied after its commits for "
                f"device_decode_dedup in {time.perf_counter() - t0:.1f} s")

        with capture, reducer, timer, decode_timer:
            # the oracles come from their process at the first check,
            # after the dedup write
            drive("dedup_bigint", bigint_schema(base), batches,
                  lambda what, got: check_rows(what, got, cols,
                                               oracles.get()[0], "id"),
                  after_write=copy_dedup)
            win, agg_want = oracles.get()
            # the same files read through the device decode plane
            decoded["dedup"] = path("device_decode_dedup",
                                    lambda: device_decode_dedup(
                                        decode_dir, rows, rec, cols, win,
                                        decode_timer))
            decoded["dedup_winner_frac"] = len(win) / rows
            decoded["pyarrow_rows_per_s"] = {
                p["phase"]: p["rows_per_s"] for p in phases
                if p["table"] == "dedup_bigint"}
            # BASELINE config 4 (bench.py BENCH_SHAPE=config4): the same
            # batches under aggregation sum/max, ORC runs at level 0,
            # parquet after compaction
            drive("agg_sum_max_orc", bigint_schema({
                **base, "merge-engine": "aggregation",
                "fields.v1.aggregate-function": "sum",
                "fields.v2.aggregate-function": "max",
                "fields.v3.aggregate-function": "max",
                "file.format": "parquet",
                "file.format.per.level": "0:orc"}), batches,
                lambda what, got: check_agg(what, got, agg_want))
            del batches, cols, win, agg_want

            s_batches = string_key_batches()
            s_cols = {"name": pa.concat_arrays(
                          [b.column("name").combine_chunks()
                           for b in s_batches]),
                      "v1": np.concatenate([b.column("v1").to_numpy()
                                            for b in s_batches])}
            s_win = last_writer_oracle(np.asarray(
                s_cols["name"].to_pylist(), dtype=object))
            s_schema = (Schema.builder().column("name", VarCharType(False))
                        .column("v1", BigIntType()).primary_key("name")
                        .options(base).build())
            drive("string_key_coverage", s_schema, s_batches,
                  lambda what, got: check_rows(what, got, s_cols, s_win,
                                               "name"))

            pu_keys = COVERAGE_KEYS
            pu_schema, pu_batches, pu_kinds = partial_update_table(pu_keys)

            def pu_check(what, got):
                # a scan folds a DELETE into its key's row; compaction
                # then drops keys whose last version is a DELETE, as the
                # reference does
                if got.column_names != [f.name for f in pu_schema.fields] \
                        or not 0 < got.num_rows <= pu_keys or \
                        ("scan" in what and got.num_rows != pu_keys):
                    raise AssertionError(f"{what}: {got.num_rows} rows")
            card = drive("partial_update_coverage", pu_schema, pu_batches,
                         pu_check, row_kinds=pu_kinds, repeat_scan=True)
            # the same table run by the port on the CPU, as its reference
            cpu = drive_table(os.path.join(work, "partial_update_cpu"),
                              pu_schema, pu_batches, pu_check, rec,
                              row_kinds=pu_kinds, device="cpu")
            # BASELINE config 5: changelog-producer=lookup
            c5.update(path("changelog_lookup_upsert",
                           lambda: changelog_lookup_upsert(
                               work, rec, timer, **c5)))
            path("changelog_producers_coverage",
                 lambda: changelog_producers_coverage(work, rec))
            decoded["coverage"] = path("device_decode_coverage",
                                       lambda: device_decode_coverage(work))
            # many buckets compacted as lanes of one batched merge, and
            # the all_to_all rescale
            mesh.update(path("mesh_compaction",
                             lambda: mesh_compaction(work, rec)))
            # merged point lookups from the query service's handler
            # threads
            served.update(path("serving", lambda: serving(work, rec)))
            # the serving fleet: replicas behind the router over an
            # object store, the host-SSD tier, warm boot, hedged reads,
            # breakers and deadlines
            fleet.update(path("serving_fleet",
                              lambda: serving_fleet(work, rec)))
            # primary-key tables in Paimon's default (dynamic), postpone
            # and cross-partition bucket modes, and schema evolution
            bucketed.update(path("bucket_modes",
                                 lambda: bucket_modes(work, rec)))
            # the maintenance plane on a daily-partitioned table:
            # expiry, tags, branches, partitions, orphans, fsck, repair
            maintained.update(path("maintenance",
                                   lambda: maintenance(work, rec)))
            # spilling writes, local merge, the plan cache and the stats
            # sidecar, retries, upload staging and the corrupt skip
            planes.update(path("write_read_planes",
                               lambda: write_read_planes(work, rec)))
            # per-file indexes: written, skipped by the scan, compacted
            # and retrofitted by rewrite_file_index
            indexed.update(path("file_indexes",
                                lambda: file_indexes(work, rec)))
            # append tables: deletion vectors, append compaction,
            # sort-compact's curve keys ranked on the card, row tracking
            # and the global index
            appended.update(path("append_tables",
                                 lambda: append_tables(work, rec)))
            # data formats and types: blob sidecars and VARIANT columns
            # at 2 GiB, avro, csv, json and mosaic data files, and the
            # table surfaces over them
            formatted.update(path("formats_types",
                                  lambda: formats_types(work, rec)))
            # the catalog and SQL: DDL, DML, MERGE INTO, time travel and
            # the procedures through create_catalog and SQLContext, the
            # JDBC and REST catalogs, privileges, views and functions,
            # and the CLI on the card
            sqled.update(path("catalog_sql",
                              lambda: catalog_sql(work, rec)))
            # CDC ingest and the streaming daemon: a growing JSONL file
            # tailed by the daemon's ingest, compaction and serve loops,
            # a kill and its recovery, two changelog consumers, and the
            # coverage of the CDC formats, database sync, the CLI, flight
            # dumps and the merged trace
            streamed.update(path("stream_cdc",
                                 lambda: stream_cdc(work, rec)))
            # search: brute force, IVF-PQ and IVF-SQ over SIFT1M's shape
            # through SQL and the Python API, HNSW, IVF-Flat, full-text
            # and hybrid search
            searched.update(path("search", lambda: search(work, rec)))
            # the multihost phase's processes start here, so that their
            # start on the card overlaps lake_interop
            mh_children = MhChildren(work, "cuda")
            # the Iceberg export through a REST catalog, the multi-writer
            # ingest topology, the loaders and the VFS
            laked.update(path("lake_interop",
                              lambda: lake_interop(work, rec)))
            # the multi-host planes: the write plane, the maintenance
            # plane and the plane-mode stream daemon across processes
            # that share the card; their launches join the main path's
            multihost.update(path("multihost_planes",
                                  lambda: multihost_planes(work, rec,
                                                           mh_children)))
            totals[0] += multihost["k1_launches"]["plain"]
            totals[1] += multihost["k1_launches"]["ovc"]
            # the analysis plane: `paimon lint` over the checkout, every
            # rule against a known-bad package, and the request deadline
            # in the streamed compaction's waits (ROADMAP C.12)
            analysed.update(path("analysis", lambda: analysis(work, rec)))
        moved = counter_delta(planes0)
        injected = sum(planes["faults_500K"]["faults"].values()) + \
            sum(indexed["fi_rewrite_coverage"]["faults"].values())
        if moved["read_retries"] + moved["write_retries"] != injected or \
                moved["sidecar_fallbacks"]:
            raise AssertionError(f"the run retried or fell back beyond "
                                 f"the {injected} faults faults_500K and "
                                 f"fi_rewrite_coverage injected: {moved}")
        log(f"read and write planes over the run: {moved}")
        for what in ("scan", "read"):
            same_tables(f"partial_update_coverage {what}: card vs cpu",
                        card[what], cpu[what], approx=("fsum",), rtol=1e-12)
        again = card["scan again"].column("fsum").combine_chunks()
        if card["scan"].column("fsum").combine_chunks().to_numpy(
                zero_copy_only=False).tobytes() != again.to_numpy(
                zero_copy_only=False).tobytes():
            raise AssertionError("partial_update_coverage: the float sum "
                                 "differs between two scans on the card")
        log("partial_update_coverage: card == cpu (fsum within rtol 1e-12); "
            "fsum bit-identical across two scans on the card")
        log(f"main path launches: plain={totals[0]} ovc={totals[1]}; by "
            f"(table, variant, lanes, n): {sorted(capture.calls.items())}; "
            f"inputs copied aside in {capture.seconds:.2f} s (not in phase "
            f"times)")
        for p in phases:
            # append tables merge nothing: their launches (the curve
            # ranks, the global index) are checked in their phase
            if p["device"] == "cuda" and p["phase"] in ("write", "scan",
                                                         "compact") and \
                    p["table"] not in APPEND_TABLES and \
                    p["launches_plain"] + p["launches_ovc"] == 0:
                raise AssertionError(f"{p['table']} {p['phase']}: no kernel "
                                     f"launch")
            if p["table"] in BIG_TABLES and p["device"] == "cuda" and \
                    p["phase"] in ("write", "scan", "compact") and \
                    p["routes"]["device"] == 0:
                raise AssertionError(f"{p['table']} {p['phase']}: host merge "
                                     f"routes only ({p['routes']})")
            if p["table"] == "agg_sum_max_orc" and \
                    p["phase"] in ("scan", "compact") and \
                    p["launches_ovc"] == 0:
                raise AssertionError(f"agg_sum_max_orc {p['phase']}: the "
                                     f"offset-value-code variant did not "
                                     f"launch")
        for caller in ("merge", "diff ranks"):
            if not any(k[0] == "changelog_lookup_upsert" and k[4] == caller
                       for k in capture.calls):
                raise AssertionError(f"changelog_lookup_upsert: no kernel "
                                     f"launch from the {caller}")
        if totals[0] == 0 or totals[1] == 0:
            raise AssertionError(f"a kernel was not launched on the main "
                                 f"path: {totals}")
        return tuple(totals)
    finally:
        if oracles is not None:
            oracles.stop()
        if mh_children is not None:
            mh_children.stop()
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="rows of the main-path table (10 commits)")
    ap.add_argument("--c5-keys", type=int, default=C5_KEYS,
                    help="keys of the config-5 bucket")
    ap.add_argument("--c5-commits", type=int, default=C5_COMMITS,
                    help="streaming commits of config 5")
    ap.add_argument("--c5-rows-per-commit", type=int, default=C5_PER_COMMIT,
                    help="upserts in each config-5 commit")
    ap.add_argument("--compare-timers", action="store_true",
                    help="only build the kernels and time K1 and K2 at "
                         "2^27 rows by the profiler and by CUDA events")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import paimon_tpu_torch  # noqa: F401  (fails outside a checkout)
    from paimon_tpu_torch import native
    from paimon_tpu_torch.ops import kernels

    log(card_line())
    t_start = time.perf_counter()
    log(f"kernel build: {kernels.build():.2f} s (nvcc, sm_90a)")
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the host merge routes' C library did not "
                             "build or load")
    log(f"C library build and load: {time.perf_counter() - t0:.2f} s "
        f"({native.load()._name})")
    if args.compare_timers:
        compare_timers()
        return 0

    with switched("PAIMON_FORCE_DEVICE_SORT"):
        check_sorted_winners()
    check_segment_reductions()
    phases: list = []
    capture = LaunchCapture()
    c5 = {"keys": args.c5_keys, "commits": args.c5_commits,
          "per_commit": args.c5_rows_per_commit}
    decoded: dict = {}
    mesh: dict = {}
    served: dict = {}
    bucketed: dict = {}
    maintained: dict = {}
    planes: dict = {}
    indexed: dict = {}
    appended: dict = {}
    formatted: dict = {}
    sqled: dict = {}
    streamed: dict = {}
    searched: dict = {}
    fleet: dict = {}
    laked: dict = {}
    multihost: dict = {}
    analysed: dict = {}
    launches = main_path(args.rows, phases, capture, ReduceTimer(),
                         ChangelogTimer(), c5, DecodeTimer(), decoded, mesh,
                         served, bucketed, maintained, planes, indexed,
                         appended, formatted, sqled, streamed, searched,
                         fleet, laked, multihost, analysed)
    k1 = KernelStats("eq_next_mask", "paimon_tpu/ops/pallas_kernels.py:72")
    k2 = KernelStats("eq_next_mask_ovc",
                     "paimon_tpu/ops/pallas_kernels.py:72")
    t0 = time.perf_counter()
    check_kernels(capture, k1, k2)
    log(f"kernel checks at the main path's shapes: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"edge sizes: {check_edges()} cases exact (sizes {EDGE_SIZES}, "
        f"lanes {EDGE_LANES}, aligned and shifted by 4 bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"lane stride: {check_seg_edges()} cases exact and equal to "
        f"separate 1-D calls (B {SEG_BATCHES}, N {SEG_ROWS}, L "
        f"{SEG_LANES}, random and all-equal lanes) in "
        f"{time.perf_counter() - t0:.1f} s")

    c5["joint_ranks"] = check_joint_ranks()
    t0 = time.perf_counter()
    routes = merge_routes(decoded["dedup_winner_frac"])
    log(f"merge routes: {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    # again at the end, so a reader of the output's tail has it too
    log(card_line())
    print(json.dumps({"changelog_lookup_upsert": c5}))
    print(json.dumps({"device_decode": decoded}))
    print(json.dumps({"mesh_compaction": mesh}))
    print(json.dumps({"serving": served}))
    print(json.dumps({"serving_fleet": fleet}))
    print(json.dumps({"merge_routes": routes}))
    print(json.dumps({"bucket_modes": bucketed}))
    print(json.dumps({"maintenance": maintained}))
    print(json.dumps({"write_read_planes": planes}))
    print(json.dumps({"file_indexes": indexed}))
    print(json.dumps({"append_tables": appended}))
    print(json.dumps({"formats_types": formatted}))
    print(json.dumps({"catalog_sql": sqled}))
    print(json.dumps({"stream_cdc": streamed}))
    orders = next(v for k, v in streamed.items()
                  if k.startswith("stream_orders"))
    print(json.dumps({"stream": {
        "card": streamed["card"],
        **{k: orders[k] for k in (
            "events", "change_rows", "events_per_s", "change_rows_per_s",
            "s", "freshness_ms", "checkpoint_ms", "checkpoints",
            "compactions", "compactions_paused", "loop_restarts",
            "recover_s", "drain_s", "k1_by_shape", "k1_by_thread",
            "peak_gib", "rss_gib")},
        "phase_s": streamed["s"]}}))
    vec = next(v for k, v in searched.items() if k.startswith("vec_sift"))
    print(json.dumps({"search": {
        "card": searched["card"], "phase_s": searched["s"],
        "programs": searched["programs"],
        **{k: vec[k] for k in (
            "rows", "queries", "bruteforce_l2", "bruteforce_cosine",
            "bruteforce_dot", "ivfpq", "ivfsq", "launches_plain",
            "peak_gib")},
        "write_rows_per_s": vec["rows"] / vec["steps_s"][
            f"write x{SEARCH_COMMITS}"],
        "read_s": vec["steps_s"]["read"],
        "coverage_s": searched["search_coverage"]["s"]}}))
    ice = next(v for k, v in laked.items() if k.startswith("ice_orders"))
    ice_phase = {p["phase"]: p for p in phases
                 if p["table"].startswith("ice_orders")}
    print(json.dumps({"lake_interop": {
        "card": laked["card"], "phase_s": laked["s"],
        "peak_gib": laked["peak_gib"], "rows": ice["rows"],
        "live": ice["live"], "k1_by_thread": ice["k1_by_thread"],
        **{f"{k}_rows_per_s": ice_phase[k]["rows_per_s"] for k in (
            f"topology write x{LAKE_CHECKPOINTS}", "full compaction",
            "full compaction 2", "iceberg read (files) after the compaction",
            "iceberg read (rest) after the compaction")},
        "syncs": ice["syncs"], "loader": ice["loader"],
        "coverage_s": laked["lake_coverage"]["s"]}}))
    print(json.dumps({"multihost_planes": multihost}))
    print(json.dumps({"analysis": analysed}))
    print(json.dumps({"stages": {
        "card": card_line(),
        **stage_split(phases, ("dedup_bigint", "agg_sum_max_orc",
                               "fi_point_16M"))}}))
    print(json.dumps({"phases": phases}))
    print(json.dumps({"kernels": [k1.record(launches[0]),
                                  k2.record(launches[1])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
