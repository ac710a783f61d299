"""Chunked paged serving: scheduler, cache manager, executor, paged steps."""
