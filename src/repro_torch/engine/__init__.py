"""The paged rollout worker, its block allocator and its sampler."""
