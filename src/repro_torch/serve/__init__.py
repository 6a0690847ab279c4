"""INT8-resident serving: residency, paged KV pool, continuous batcher."""
