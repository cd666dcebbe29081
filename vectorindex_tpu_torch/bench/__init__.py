"""Benchmark harness of the port (reference L6: Sources/VectorIndexBenchmarks
+ L2SqrMicrobench): seeded corpora and `*vecs` files (`datagen`), the
content-keyed artifact cache (`cache`), bulk builders of index state and
exact truth (`synth`), device timing (`timing`), per-index suites
(`harness`) and the CLI. Run as `python -m vectorindex_tpu_torch.bench
--help`; every entry point runs on the card unless given `device="cpu"`
(`--device cpu`)."""
