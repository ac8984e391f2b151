"""Data pipeline of the port: the NMR sharder, tar and raw shards,
decode, batching."""
