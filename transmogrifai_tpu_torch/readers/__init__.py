"""Reader tier: per-file readers (csv_reader, avro_reader with its
ParquetReader), the native chunked CSV scanner (fast_csv) with the
double-buffered device ingest (``DeviceCSVIngest``) and its Parquet
sibling (arrow_ingest), the event readers (events: aggregate,
conditional, joined, streaming), and the async sharded input pipeline
(pipeline: shard -> interleave -> map -> prefetch, with the
``PipelinedCSVReader`` streaming seam of ``OpWorkflow.train``)."""
