"""Token-block hashing and the paged KV block pool."""
