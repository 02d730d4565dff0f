"""The rollout worker (paged or dense), its block allocator and sampler, and the
runtime around it: execution backends, the worker fleet, the simulator, the
workload generator and the tool environment."""
