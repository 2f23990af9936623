"""The benchmark's harness: generator, the entry into the program, spans, trace,
yardsticks and the correctness check."""
