"""Service components of the serving graph (the KV-aware processor)."""
