"""Reader tier: the CSV reader (csv_reader) and the native chunked CSV
scanner behind it (fast_csv).  The Avro, Parquet and event readers and
the async sharded input pipeline come with the host-side operations
subsystems (ROADMAP.md queue 1, item 12)."""
