"""Multi-device runs over `torch.distributed` (port of `ngravs_tpu/parallel/`).

One process per rank, as the reference runs one MPI rank per process
(`mpirun -n K`): every rank runs the same program on its shard of the
particles, on its own device, and the JAX package's `shard_map`
collectives become `torch.distributed` calls (`mesh.Mesh`)."""
