"""Where the reference places each tensor on a worker's mesh, and the explicit
tensor-parallel split that the port's workers execute."""
