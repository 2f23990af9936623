"""Reader tier: per-file readers (csv_reader, avro_reader with its
ParquetReader), the native chunked CSV scanner (fast_csv) with the
double-buffered device ingest (``DeviceCSVIngest``) and its Parquet
sibling (arrow_ingest), and the event readers (events: aggregate,
conditional, joined, streaming).  The async sharded input pipeline comes
with the host-side operations subsystems (ROADMAP.md queue 1, item 12)."""
