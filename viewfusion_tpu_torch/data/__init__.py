"""Data pipeline of the port: tar and raw shards, decode, batching."""
